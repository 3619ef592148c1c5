"""Synthetic molecular graphs and the packed batch layout, made from a
seed in bulk with numpy.

A frozen, vectorised copy of the distribution of the port's
``data.pipeline.make_graph``: a graph has ``clip(Poisson(avg_nodes), 4,
max_nodes)`` nodes; node i > 0 hangs off a parent drawn uniformly from
the nodes before it, and each tree edge is stored both ways (first
every child -> parent edge, then every parent -> child edge), followed
by ``int(n * (avg_degree - 2) / 2)`` ring-closing pairs; at most
``max_edges`` edges are kept; node and edge features are standard
normal. The numbers differ from the port's generator for the same seed;
the distribution and the layout are the same.

``pack`` lays ``B`` consecutive graphs into one batch as the port's
``data.pipeline.pack_graphs`` does: node and edge slots of graph k carry
graph id k, padding slots graph id ``B`` and padding edges the ids -1;
edge endpoints are global node slots.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the keys of a packed batch, in the port's layout (the host-only target
# buffer ``y`` is left out: the served path never reads it)
BATCH_KEYS = ("node_feat", "node_graph_id", "edge_index", "edge_feat",
              "edge_graph_id", "graph_valid", "graph_num_nodes",
              "num_graphs")


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Size statistics of a graph dataset (a configuration's
    ``dataset``)."""
    avg_nodes: float
    avg_degree: float
    node_feat_dim: int
    edge_feat_dim: int
    max_nodes: int = 600
    max_edges: int = 600

    @classmethod
    def from_config(cls, d: dict) -> "Dataset":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


@dataclasses.dataclass
class Graphs:
    """``G`` graphs in flat arrays: per graph its node and edge counts,
    per edge its local endpoints, the features of all nodes and edges in
    graph order."""
    num_nodes: np.ndarray      # (G,) int64
    num_edges: np.ndarray      # (G,) int64
    src: np.ndarray            # (sum num_edges,) int32, local ids
    dst: np.ndarray
    node_feat: np.ndarray      # (sum num_nodes, F) float32
    edge_feat: np.ndarray      # (sum num_edges, Fe) float32


def _segment_index(counts: np.ndarray) -> tuple:
    """For segments of ``counts`` elements: each element's segment and
    its position inside it."""
    seg = np.repeat(np.arange(counts.size), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return seg, np.arange(int(counts.sum())) - starts[seg]


def make_graphs(ds: Dataset, count: int,
                rng: np.random.Generator) -> Graphs:
    """``count`` graphs of ``ds``'s distribution, drawn from ``rng``."""
    n = np.clip(rng.poisson(ds.avg_nodes, count), 4,
                ds.max_nodes).astype(np.int64)
    # tree edges: node i (1 <= i < n) and its parent, uniform in [0, i)
    g_tree, pos = _segment_index(n - 1)
    child = pos + 1
    parent = np.minimum((rng.random(child.size) * child).astype(np.int64),
                        child - 1)
    # ring-closing pairs: a uniform, b = a + 1 + uniform [0, n - 1) mod n
    extra = np.maximum(0, (n * (ds.avg_degree - 2) / 2).astype(np.int64))
    g_ext, _ = _segment_index(extra)
    ne = n[g_ext]
    a = (rng.random(g_ext.size) * ne).astype(np.int64)
    b = (a + 1 + (rng.random(g_ext.size) * (ne - 1)).astype(np.int64)) % ne
    # per graph, in make_graph's order: child->parent, parent->child,
    # a->b, b->a; a stable sort by graph keeps that order inside a graph
    graph = np.concatenate([g_tree, g_tree, g_ext, g_ext])
    part = np.concatenate([np.zeros(g_tree.size), np.ones(g_tree.size),
                           np.full(g_ext.size, 2), np.full(g_ext.size, 3)])
    src = np.concatenate([child, parent, a, b])
    dst = np.concatenate([parent, child, b, a])
    order = np.lexsort((part, graph))
    graph, src, dst = graph[order], src[order], dst[order]
    # keep each graph's first max_edges edges
    full = np.bincount(graph, minlength=count)
    _, rank = _segment_index(full)
    keep = rank < ds.max_edges
    e = np.minimum(full, ds.max_edges).astype(np.int64)
    node_feat = rng.standard_normal((int(n.sum()), ds.node_feat_dim),
                                    dtype=np.float32)
    edge_feat = rng.standard_normal((int(e.sum()), ds.edge_feat_dim),
                                    dtype=np.float32)
    return Graphs(n, e, src[keep].astype(np.int32),
                  dst[keep].astype(np.int32), node_feat, edge_feat)


def budget(batch_graphs: int, avg_count: float, slack: float,
           multiple: int) -> int:
    """Slots of a batch: ``slack`` x the expected total plus one, rounded
    up to a multiple of ``multiple`` (the port's
    ``data.pipeline.size_budget``)."""
    raw = int(batch_graphs * avg_count * slack) + 1
    return -(-raw // multiple) * multiple


def pack(gs: Graphs, first: int, batch_graphs: int, node_budget: int,
         edge_budget: int) -> dict:
    """Graphs ``first`` ... ``first + batch_graphs - 1`` of ``gs`` as one
    packed batch (numpy). Raises ValueError where they overflow a
    budget."""
    sl = slice(first, first + batch_graphs)
    n, e = gs.num_nodes[sl], gs.num_edges[sl]
    nodes, edges = int(n.sum()), int(e.sum())
    if nodes > node_budget or edges > edge_budget:
        raise ValueError(f"{batch_graphs} graphs hold {nodes} nodes / "
                         f"{edges} edges, over the budgets {node_budget} / "
                         f"{edge_budget}")
    n0 = int(gs.num_nodes[:first].sum())
    e0 = int(gs.num_edges[:first].sum())
    node_gid, _ = _segment_index(n)
    edge_gid, _ = _segment_index(e)
    offset = np.concatenate([[0], np.cumsum(n)[:-1]])[edge_gid]
    b = {"node_feat": np.zeros((node_budget, gs.node_feat.shape[1]),
                               np.float32),
         "node_graph_id": np.full((node_budget,), batch_graphs, np.int32),
         "edge_index": np.full((edge_budget, 2), -1, np.int32),
         "edge_feat": np.zeros((edge_budget, gs.edge_feat.shape[1]),
                               np.float32),
         "edge_graph_id": np.full((edge_budget,), batch_graphs, np.int32),
         "graph_valid": np.ones((batch_graphs,), bool),
         "graph_num_nodes": n.astype(np.int32),
         "num_graphs": np.int32(batch_graphs)}
    b["node_feat"][:nodes] = gs.node_feat[n0:n0 + nodes]
    b["node_graph_id"][:nodes] = node_gid
    b["edge_index"][:edges, 0] = gs.src[e0:e0 + edges] + offset
    b["edge_index"][:edges, 1] = gs.dst[e0:e0 + edges] + offset
    b["edge_feat"][:edges] = gs.edge_feat[e0:e0 + edges]
    b["edge_graph_id"][:edges] = edge_gid
    return b


def batch_counts(b: dict) -> tuple:
    """(graphs, real nodes, valid edges) of a packed batch."""
    g = int(b["num_graphs"])
    return (g, int((b["node_graph_id"] < g).sum()),
            int((b["edge_index"][:, 0] >= 0).sum()))
