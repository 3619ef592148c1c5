"""Synthetic molecular graphs and the packed GraphBatch format (numpy).

A copy of the GNN half of ``repro.data.pipeline``: the same generator,
budgets and greedy packer, so the same ``GraphDataConfig`` yields
array-equal graphs and batches in both packages. A packed batch fuses
many graphs into one budget-sized buffer: node/edge slots carry the
owning graph id, padding slots get graph id ``max_graphs`` and padding
edges ``src == -1``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphDataConfig:
    """Synthetic molecular graphs, matched to MoleculeNet statistics."""
    num_graphs: int = 1000
    avg_nodes: int = 18          # QM9-like
    avg_degree: int = 2
    node_feat_dim: int = 9
    edge_feat_dim: int = 3
    num_targets: int = 1
    max_nodes: int = 600
    max_edges: int = 600
    seed: int = 0


@dataclasses.dataclass
class Graph:
    """Padded COO graph."""
    node_feat: np.ndarray        # (max_nodes, F)
    edge_index: np.ndarray       # (max_edges, 2) int32, padded with -1
    edge_feat: np.ndarray        # (max_edges, Fe)
    num_nodes: int
    num_edges: int
    y: np.ndarray                # (num_targets,)


def make_graph(cfg: GraphDataConfig, idx: int) -> Graph:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, idx]))
    n = int(np.clip(rng.poisson(cfg.avg_nodes), 4, cfg.max_nodes))
    # molecule-like: a random spanning tree + extra ring-closing edges
    parents = np.array([rng.integers(0, max(i, 1)) for i in range(1, n)])
    src = np.concatenate([np.arange(1, n), parents])
    dst = np.concatenate([parents, np.arange(1, n)])      # undirected pairs
    extra = max(0, int(n * (cfg.avg_degree - 2) / 2))
    if extra:
        a = rng.integers(0, n, extra)
        b = (a + 1 + rng.integers(0, n - 1, extra)) % n
        src = np.concatenate([src, a, b])
        dst = np.concatenate([dst, b, a])
    e = min(len(src), cfg.max_edges)
    edge_index = np.full((cfg.max_edges, 2), -1, np.int32)
    edge_index[:e, 0] = src[:e]
    edge_index[:e, 1] = dst[:e]
    node_feat = np.zeros((cfg.max_nodes, cfg.node_feat_dim), np.float32)
    node_feat[:n] = rng.standard_normal((n, cfg.node_feat_dim))
    edge_feat = np.zeros((cfg.max_edges, cfg.edge_feat_dim), np.float32)
    edge_feat[:e] = rng.standard_normal((e, cfg.edge_feat_dim))
    # a target that actually depends on the graph (degree/feature moments)
    y = np.array([node_feat[:n].mean() + 0.1 * e / max(n, 1)]
                 * cfg.num_targets, np.float32)
    return Graph(node_feat, edge_index, edge_feat, n, e, y)


def graph_dataset(cfg: GraphDataConfig) -> list:
    return [make_graph(cfg, i) for i in range(cfg.num_graphs)]


def graph_batch(cfg: GraphDataConfig, step: int, batch_size: int) -> dict:
    """Stacked padded graphs, the padded per-graph oracle's input;
    deterministic in step."""
    idx0 = (step * batch_size) % cfg.num_graphs
    graphs = [make_graph(cfg, (idx0 + i) % cfg.num_graphs)
              for i in range(batch_size)]
    return {
        "node_feat": np.stack([g.node_feat for g in graphs]),
        "edge_index": np.stack([g.edge_index for g in graphs]),
        "edge_feat": np.stack([g.edge_feat for g in graphs]),
        "num_nodes": np.array([g.num_nodes for g in graphs], np.int32),
        "num_edges": np.array([g.num_edges for g in graphs], np.int32),
        "y": np.stack([g.y for g in graphs]),
    }


def size_budget(batch_graphs: int, avg_count: float, slack: float = 1.5,
                multiple: int = 8) -> int:
    """Budget-sizing rule: slack x the expected total covers the Poisson
    tail of graph sizes; rounded up to a multiple of ``multiple``."""
    raw = int(batch_graphs * avg_count * slack) + 1
    return -(-raw // multiple) * multiple


def graph_fits_budget(g: Graph, node_budget: int, edge_budget: int) -> bool:
    return g.num_nodes <= node_budget and g.num_edges <= edge_budget


def validate_graph(g: Graph) -> str | None:
    """Admission guard for externally-supplied graphs: ``None`` for a
    well-formed ``Graph``, else a human-readable reason string.

    ``pack_graphs`` trusts its inputs — it adds the node-slot offset to
    every active edge row, so an out-of-range endpoint would corrupt a
    neighbouring graph's rows and a NaN feature would poison the whole
    batch. Only the active prefixes are screened: padding rows are the
    format's own."""
    nf = np.asarray(g.node_feat)
    ei = np.asarray(g.edge_index)
    ef = np.asarray(g.edge_feat)
    if nf.ndim != 2:
        return f"node_feat must be 2-D (max_nodes, F), got shape {nf.shape}"
    if ei.ndim != 2 or ei.shape[1] != 2:
        return f"edge_index must be (max_edges, 2), got shape {ei.shape}"
    if ef.ndim != 2:
        return f"edge_feat must be 2-D (max_edges, Fe), got shape {ef.shape}"
    if ef.shape[0] != ei.shape[0]:
        return (f"edge_feat has {ef.shape[0]} rows but edge_index has "
                f"{ei.shape[0]}")
    n, e = int(g.num_nodes), int(g.num_edges)
    if not 0 <= n <= nf.shape[0]:
        return (f"num_nodes={n} outside [0, {nf.shape[0]}] "
                "(node_feat rows)")
    if not 0 <= e <= ei.shape[0]:
        return (f"num_edges={e} outside [0, {ei.shape[0]}] "
                "(edge_index rows)")
    active = ei[:e]
    if active.size and (active.min() < 0 or active.max() >= n):
        bad = int(np.argmax((active < 0).any(1) | (active >= n).any(1)))
        return (f"edge {bad} endpoints {tuple(int(v) for v in active[bad])} "
                f"out of range for num_nodes={n}")
    if not np.isfinite(nf[:n]).all():
        return "non-finite node features in the active prefix"
    if not np.isfinite(ef[:e]).all():
        return "non-finite edge features in the active prefix"
    return None


def empty_graph_batch(node_budget: int, edge_budget: int, max_graphs: int,
                      node_feat_dim: int, edge_feat_dim: int,
                      num_targets: int = 1) -> dict:
    """All-padding GraphBatch (``num_graphs == 0``) in the standard
    layout: node/edge slots in the overflow bucket (graph id ==
    max_graphs, edge src == -1), no valid graphs."""
    return {"node_feat": np.zeros((node_budget, node_feat_dim), np.float32),
            "node_graph_id": np.full((node_budget,), max_graphs, np.int32),
            "edge_index": np.full((edge_budget, 2), -1, np.int32),
            "edge_feat": np.zeros((edge_budget, edge_feat_dim), np.float32),
            "edge_graph_id": np.full((edge_budget,), max_graphs, np.int32),
            "graph_valid": np.zeros((max_graphs,), bool),
            "graph_num_nodes": np.zeros((max_graphs,), np.int32),
            "num_graphs": np.int32(0),
            "y": np.zeros((max_graphs, num_targets), np.float32)}


def pack_graphs(graphs, node_budget: int, edge_budget: int,
                max_graphs: int) -> tuple:
    """Greedily pack a prefix of ``graphs`` into one GraphBatch dict.

    Packing stops at the first graph that would overflow a budget (or at
    ``max_graphs``), keeping dataset order so output row i corresponds to
    graphs[i]. Returns (batch, n_packed). Raises ValueError if graphs[0]
    alone exceeds the budget — the caller must drop or resize.
    """
    if not graphs:
        raise ValueError("pack_graphs needs at least one graph")
    if not graph_fits_budget(graphs[0], node_budget, edge_budget):
        raise ValueError(
            f"graph with {graphs[0].num_nodes} nodes/"
            f"{graphs[0].num_edges} edges exceeds budget "
            f"({node_budget} nodes/{edge_budget} edges)")
    batch = empty_graph_batch(node_budget, edge_budget, max_graphs,
                              graphs[0].node_feat.shape[1],
                              graphs[0].edge_feat.shape[1],
                              graphs[0].y.shape[0])
    n_used = e_used = k = 0
    for g in graphs:
        if k == max_graphs or n_used + g.num_nodes > node_budget \
                or e_used + g.num_edges > edge_budget:
            break
        n, e = g.num_nodes, g.num_edges
        batch["node_feat"][n_used:n_used + n] = g.node_feat[:n]
        batch["node_graph_id"][n_used:n_used + n] = k
        batch["edge_index"][e_used:e_used + e] = g.edge_index[:e] + n_used
        batch["edge_feat"][e_used:e_used + e] = g.edge_feat[:e]
        batch["edge_graph_id"][e_used:e_used + e] = k
        batch["y"][k] = g.y
        batch["graph_valid"][k] = True
        batch["graph_num_nodes"][k] = n
        n_used += n
        e_used += e
        k += 1
    batch["num_graphs"] = np.int32(k)
    return batch, k


def pack_dataset(graphs, node_budget: int, edge_budget: int,
                 max_graphs: int) -> tuple:
    """Pack an entire dataset into a list of GraphBatch dicts.

    Graphs that can never fit the budget on their own are returned in
    ``dropped`` instead of stalling the stream. Order is preserved:
    concatenating the valid rows of each batch visits the non-dropped
    graphs in dataset order. Returns (batches, dropped)."""
    batches, dropped = [], []
    i = 0
    while i < len(graphs):
        if not graph_fits_budget(graphs[i], node_budget, edge_budget):
            dropped.append(graphs[i])
            i += 1
            continue
        batch, k = pack_graphs(graphs[i:], node_budget, edge_budget,
                               max_graphs)
        batches.append(batch)
        i += k
    return batches, dropped


def compute_average_nodes_and_edges(dataset, round_val: bool = True):
    """Paper API: gnnb.compute_average_nodes_and_edges."""
    n = float(np.mean([g.num_nodes for g in dataset]))
    e = float(np.mean([g.num_edges for g in dataset]))
    return (round(n), round(e)) if round_val else (n, e)


def compute_average_degree(dataset):
    """Paper API: gnnb.compute_average_degree, the mean over graphs of
    edges per node."""
    return float(np.mean([g.num_edges / max(g.num_nodes, 1)
                          for g in dataset]))
