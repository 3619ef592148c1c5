"""Synthetic token batches, molecular graphs and the packed GraphBatch
format (numpy).

``token_batch`` is ``repro.data.pipeline.token_batch``: a pure function
of (seed, step), so a restarted trainer resumes mid-stream with nothing
but its step counter, and the same (seed, step) gives the reference's
batch bit for bit. The rest is a copy of the GNN half of
``repro.data.pipeline``: the same generator,
budgets and greedy packer, the same shard waves (``shard_pack``,
``pack_dataset(..., num_shards=)``) and the same intra-graph partition
(``partition_graph``), so the same ``GraphDataConfig`` yields
array-equal graphs, batches, waves and partitions in both packages. A
packed batch fuses many graphs into one budget-sized buffer: node/edge
slots carry the owning graph id, padding slots get graph id
``max_graphs`` and padding edges ``src == -1``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def token_batch(cfg: TokenDataConfig, step: int) -> dict:
    """Synthetic LM batch with a learnable structure (affine-lag
    sequences, so the loss falls measurably in a short run): tokens,
    labels (the tokens shifted by one) and an all-ones mask."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xD47A]))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    base = rng.integers(0, v, size=(b, s), dtype=np.int32)
    # inject short-range structure: token[t] often = f(token[t-1])
    mult = 31 % v or 1
    lag = (base[:, :-1] * mult + 7) % v
    mask = rng.random((b, s - 1)) < 0.7
    base[:, 1:] = np.where(mask, lag, base[:, 1:])
    labels = np.concatenate([base[:, 1:], base[:, :1]], axis=1)
    return {"tokens": base, "labels": labels,
            "mask": np.ones((b, s), np.float32)}


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


# ------------------------------------------------------ sharded packing --
#
# Data-parallel execution over the ranks of a process group
# (launch.mesh.DataMesh): one *wave* is num_shards GraphBatch shards
# with identical static shapes, one per rank, each rank running the same
# program on its own shard (gnn_model.make_sharded_apply). The
# partitioner below is the graph-level analogue of GNNBuilder's
# parallelization factors one level up: instead of splitting a matmul
# over MAC lanes, it splits the request stream over ranks.

@dataclasses.dataclass
class ShardedBatch:
    """One wave of per-rank packed shards.

    ``shards`` holds ``num_shards`` GraphBatch dicts with identical
    static shapes (idle shards are ``empty_graph_batch``).
    ``index[s][j]`` is the wave-relative position of the graph packed
    into shard ``s`` row ``j`` — a permutation of range(n_graphs), so
    ``gather_shard_outputs`` can restore host order after the per-rank
    outputs come back stacked."""
    shards: list
    index: list

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def n_graphs(self) -> int:
        return sum(len(ix) for ix in self.index)


def shard_pack(graphs, node_budget: int, edge_budget: int, max_graphs: int,
               num_shards: int) -> tuple:
    """Partition a prefix of ``graphs`` into ``num_shards`` per-rank
    packed shards under the same *per-shard* node/edge budgets.

    Greedy least-loaded: each graph lands in the shard with the fewest
    used node slots that can still take it, so shards stay balanced
    while each shard's internal order follows the stream. Stops at the
    first graph no shard can accept (budgets or max_graphs bind).
    Returns (ShardedBatch, n_consumed); the consumed prefix is assigned
    exhaustively — every one of the first n_consumed graphs rides some
    shard. Raises ValueError if graphs[0] cannot fit an empty shard
    (the caller must drop or resize, as with pack_graphs)."""
    if not graphs:
        raise ValueError("shard_pack needs at least one graph")
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not graph_fits_budget(graphs[0], node_budget, edge_budget):
        raise ValueError(
            f"graph with {graphs[0].num_nodes} nodes/"
            f"{graphs[0].num_edges} edges exceeds the per-shard budget "
            f"({node_budget} nodes/{edge_budget} edges)")
    assign: list = [[] for _ in range(num_shards)]
    used_n = [0] * num_shards
    used_e = [0] * num_shards
    k = 0
    for pos, g in enumerate(graphs):
        cands = [s for s in range(num_shards)
                 if len(assign[s]) < max_graphs
                 and used_n[s] + g.num_nodes <= node_budget
                 and used_e[s] + g.num_edges <= edge_budget]
        if not cands:
            break
        s = min(cands, key=lambda s: (used_n[s], used_e[s], s))
        assign[s].append(pos)
        used_n[s] += g.num_nodes
        used_e[s] += g.num_edges
        k += 1
    f = graphs[0].node_feat.shape[1]
    fe = graphs[0].edge_feat.shape[1]
    t = graphs[0].y.shape[0]
    shards = []
    for s in range(num_shards):
        if assign[s]:
            batch, _ = pack_graphs([graphs[i] for i in assign[s]],
                                   node_budget, edge_budget, max_graphs)
        else:
            batch = empty_graph_batch(node_budget, edge_budget, max_graphs,
                                      f, fe, t)
        shards.append(batch)
    return ShardedBatch(shards, assign), k


def gather_shard_outputs(outs, index) -> np.ndarray:
    """Stacked per-shard graph outputs (num_shards, max_graphs, ...) ->
    wave host order (n_graphs, ...), inverting a ShardedBatch's
    ``index`` permutation. Graph tasks only — node-task outputs are
    per-shard packed node tables with no global row order to restore."""
    outs = np.asarray(outs)
    n = sum(len(ix) for ix in index)
    host = np.zeros((n,) + outs.shape[2:], outs.dtype)
    for s, ix in enumerate(index):
        for j, pos in enumerate(ix):
            host[pos] = outs[s, j]
    return host


def pack_dataset(graphs, node_budget: int, edge_budget: int,
                 max_graphs: int, num_shards: int = 1) -> tuple:
    """Pack an entire dataset into a list of GraphBatch dicts.

    Graphs that can never fit the budget on their own are returned in
    ``dropped`` instead of stalling the stream. Order is preserved:
    concatenating the valid rows of each batch visits the non-dropped
    graphs in dataset order. Returns (batches, dropped).

    With ``num_shards > 1`` the batches are ``ShardedBatch`` *waves*
    instead: each wave carries ``num_shards`` per-rank shards under the
    same per-shard budgets (``shard_pack``), and concatenating the
    waves' ``gather_shard_outputs`` results visits the non-dropped
    graphs in dataset order."""
    batches, dropped = [], []
    i = 0
    while i < len(graphs):
        if not graph_fits_budget(graphs[i], node_budget, edge_budget):
            dropped.append(graphs[i])
            i += 1
            continue
        if num_shards > 1:
            wave, k = shard_pack(graphs[i:], node_budget, edge_budget,
                                 max_graphs, num_shards)
            batches.append(wave)
        else:
            batch, k = pack_graphs(graphs[i:], node_budget, edge_budget,
                                   max_graphs)
            batches.append(batch)
        i += k
    return batches, dropped


# ------------------------------------------------- intra-graph partition --
#
# Giant-graph partitioned inference: one graph larger than the packed
# node/edge budgets is split into per-rank subgraphs under the same
# per-shard budgets, each carrying a *halo* (replicated boundary-node
# rows plus a fixed-shape exchange index), so that between
# message-passing layers the ranks swap updated halo features over the
# process group (gnn_model.apply_packed_partitioned). Edge ownership
# follows the destination: the owner of an edge's dst holds the edge, so
# every aggregation is computed entirely on one rank and only node
# *rows* cross the group. The exchange is all-gather-of-boundary-rows
# (point-to-point later); comm volume is what the DSE's `partition` axis
# prices (convs.halo_comm_bytes).

#: batch keys carried only by partitioned per-rank batches (consumed by
#: the partitioned program's exchange and tail, not by apply_packed)
PARTITION_HALO_KEYS = ("halo_send", "halo_recv_src", "halo_recv_dst",
                       "node_global_id", "total_nodes")


@dataclasses.dataclass
class GraphPartition:
    """One oversize graph split into ``num_parts`` per-rank subgraphs.

    ``parts`` holds per-rank GraphBatch dicts (``max_graphs == 1``,
    identical static shapes) with the standard packed layout — owned
    rows first, then halo rows, then padding — plus the partition-only
    keys: ``node_in_deg``/``node_out_deg`` (true *global* degrees, so
    GCN normalization is exact even for halo sources whose in-edges
    live on their owner), ``node_global_id`` (reassembly scatter index,
    out-of-range sentinel on halo/padding rows),
    ``halo_send`` (owned local rows to publish, -1 pad),
    ``halo_recv_src`` (index into the (P*halo_budget, F) all-gathered
    publish buffer), ``halo_recv_dst`` (local halo row to overwrite,
    sentinel ``node_budget`` pad) and ``total_nodes``."""
    parts: list
    num_parts: int
    total_nodes: int
    total_edges: int
    cut_edges: int
    halo_nodes: int          # total replicated boundary rows across parts
    node_budget: int
    edge_budget: int
    halo_budget: int
    #: row count of the source graph's padded node buffer — the
    #: reassembly buffer is sized to it so partitioned pooling reduces
    #: over the exact same shape as the padded oracle (bitwise parity)
    padded_nodes: int = 0

    def comm_bytes(self, feat_dim: int, bytes_per_value: float,
                   num_layers: int) -> float:
        """Modeled exchange volume: edge-cut x feature bytes per layer
        boundary (the DSE comm-cost term, convs.halo_comm_bytes)."""
        return (float(self.cut_edges) * float(feat_dim)
                * float(bytes_per_value) * max(num_layers - 1, 0))


def partition_graph(g: Graph, num_parts: int, node_budget: int,
                    edge_budget: int, halo_budget: int | None = None
                    ) -> GraphPartition:
    """Greedy edge-cut partition of one graph into ``num_parts``
    per-rank subgraphs under the per-shard budgets.

    Nodes are streamed in BFS order (lowest unvisited id seeds each
    component) and assigned to the part holding most of their
    already-assigned neighbors (LDG-style greedy, capacity
    ``ceil(n / num_parts)``; ties go to the least-loaded part). BFS
    order makes the greedy fill each part with one connected region,
    so the cut is the BFS frontier at each capacity boundary rather
    than a random bisection of every edge. Each edge is owned by the owner of its
    *destination*, so a destination's full in-neighborhood reduces on
    one rank and only boundary-node rows are exchanged. Raises
    ``ValueError`` when any part would exceed a budget (owned + halo
    rows > node_budget, owned edges > edge_budget, or boundary rows >
    halo_budget) — the caller falls back to the padded oracle."""
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    if halo_budget is None:
        halo_budget = node_budget
    n, e = int(g.num_nodes), int(g.num_edges)
    src = np.asarray(g.edge_index[:e, 0], np.int64)
    dst = np.asarray(g.edge_index[:e, 1], np.int64)
    # -- greedy LDG node assignment -------------------------------------
    own_cap = max(-(-n // num_parts), 1)
    owner = np.full((n,), -1, np.int64)
    owned_count = np.zeros((num_parts,), np.int64)
    neighbors: list = [[] for _ in range(n)]
    for s, d in zip(src, dst):
        neighbors[s].append(int(d))
        neighbors[d].append(int(s))
    order: list = []
    visited = np.zeros((n,), bool)
    for seed in range(n):
        if visited[seed]:
            continue
        visited[seed] = True
        frontier = [seed]
        while frontier:
            v = frontier.pop(0)
            order.append(v)
            for u in sorted(set(neighbors[v])):
                if not visited[u]:
                    visited[u] = True
                    frontier.append(u)
    for v in order:
        score = np.zeros((num_parts,), np.int64)
        for u in neighbors[v]:
            if owner[u] >= 0:
                score[owner[u]] += 1
        score[owned_count >= own_cap] = -1
        cands = np.flatnonzero(score == score.max())
        p = int(min(cands, key=lambda c: (owned_count[c], c)))
        owner[v] = p
        owned_count[p] += 1
    # -- edge ownership + halo sets -------------------------------------
    edge_owner = owner[dst] if e else np.zeros((0,), np.int64)
    cut = int(np.sum(owner[src] != owner[dst])) if e else 0
    indeg = np.bincount(dst, minlength=n).astype(np.float32) if n else \
        np.zeros((0,), np.float32)
    outdeg = np.bincount(src, minlength=n).astype(np.float32) if n else \
        np.zeros((0,), np.float32)
    owned_nodes = [np.flatnonzero(owner == p) for p in range(num_parts)]
    edge_rows = [np.flatnonzero(edge_owner == p) for p in range(num_parts)]
    halo_nodes = []
    for p in range(num_parts):
        rows = edge_rows[p]
        remote = src[rows][owner[src[rows]] != p] if rows.size else \
            np.zeros((0,), np.int64)
        halo_nodes.append(np.unique(remote))
    send_nodes = []
    for p in range(num_parts):
        needed = [h[owner[h] == p] for h in halo_nodes]
        send_nodes.append(np.unique(np.concatenate(needed)) if needed
                          else np.zeros((0,), np.int64))
    for p in range(num_parts):
        n_own, n_halo = len(owned_nodes[p]), len(halo_nodes[p])
        if n_own + n_halo > node_budget:
            raise ValueError(
                f"part {p}: {n_own} owned + {n_halo} halo rows exceed "
                f"node_budget {node_budget}")
        if len(edge_rows[p]) > edge_budget:
            raise ValueError(
                f"part {p}: {len(edge_rows[p])} owned edges exceed "
                f"edge_budget {edge_budget}")
        if max(n_halo, len(send_nodes[p])) > halo_budget:
            raise ValueError(
                f"part {p}: {max(n_halo, len(send_nodes[p]))} boundary "
                f"rows exceed halo_budget {halo_budget}")
    # -- per-part batches ------------------------------------------------
    f = g.node_feat.shape[1]
    fe = g.edge_feat.shape[1]
    t = g.y.shape[0]
    # out-of-range for any reassembly buffer: the drop-mode scatter
    # ignores halo/padding rows no matter how the buffer is sized
    gid_sentinel = np.int32(2 ** 30)
    # global node id -> (part-local send position) for recv_src lookup
    send_pos = {}
    for p in range(num_parts):
        for j, v in enumerate(send_nodes[p]):
            send_pos[int(v)] = p * halo_budget + j
    parts = []
    for p in range(num_parts):
        own = owned_nodes[p]
        halo = halo_nodes[p]
        n_own, n_halo = len(own), len(halo)
        local = np.full((max(n, 1),), -1, np.int64)
        local[own] = np.arange(n_own)
        local[halo] = n_own + np.arange(n_halo)
        batch = empty_graph_batch(node_budget, edge_budget, 1, f, fe, t)
        batch["node_feat"][:n_own] = g.node_feat[own]
        batch["node_feat"][n_own:n_own + n_halo] = g.node_feat[halo]
        batch["node_graph_id"][:n_own + n_halo] = 0
        rows = edge_rows[p]
        ne = len(rows)
        batch["edge_index"][:ne, 0] = local[src[rows]]
        batch["edge_index"][:ne, 1] = local[dst[rows]]
        batch["edge_feat"][:ne] = g.edge_feat[rows]
        batch["edge_graph_id"][:ne] = 0
        batch["graph_valid"][0] = True
        batch["graph_num_nodes"][0] = n_own + n_halo
        batch["num_graphs"] = np.int32(1)
        batch["y"][0] = g.y
        # true global degrees for every active local row (owned + halo)
        deg_in = np.zeros((node_budget,), np.float32)
        deg_out = np.zeros((node_budget,), np.float32)
        deg_in[:n_own] = indeg[own]
        deg_in[n_own:n_own + n_halo] = indeg[halo]
        deg_out[:n_own] = outdeg[own]
        deg_out[n_own:n_own + n_halo] = outdeg[halo]
        batch["node_in_deg"] = deg_in
        batch["node_out_deg"] = deg_out
        gid = np.full((node_budget,), gid_sentinel, np.int32)
        gid[:n_own] = own
        batch["node_global_id"] = gid
        hs = np.full((halo_budget,), -1, np.int32)
        hs[:len(send_nodes[p])] = local[send_nodes[p]]
        batch["halo_send"] = hs
        hr_src = np.zeros((halo_budget,), np.int32)
        hr_dst = np.full((halo_budget,), node_budget, np.int32)
        for j, v in enumerate(halo):
            hr_src[j] = send_pos[int(v)]
            hr_dst[j] = n_own + j
        batch["halo_recv_src"] = hr_src
        batch["halo_recv_dst"] = hr_dst
        batch["total_nodes"] = np.int32(n)
        parts.append(batch)
    return GraphPartition(
        parts=parts, num_parts=num_parts, total_nodes=n, total_edges=e,
        cut_edges=cut, halo_nodes=int(sum(len(h) for h in halo_nodes)),
        node_budget=node_budget, edge_budget=edge_budget,
        halo_budget=halo_budget, padded_nodes=int(g.node_feat.shape[0]))


def graph_batch_packed(cfg: GraphDataConfig, step: int, node_budget: int,
                       edge_budget: int, max_graphs: int) -> dict:
    """Deterministic step-indexed packed batch: the candidate window is
    the ``max_graphs`` dataset indices starting at step * max_graphs
    (mod dataset size), packed greedily until a budget binds. Pure in
    (cfg.seed, step): a restarted worker rebuilds the identical batch.

    When a budget binds before the window is exhausted, the tail graphs
    of that window are skipped for this step. The start index rotates by
    one extra slot per epoch, so window boundaries shift across epochs
    and a skipped tail is packed on a later pass: no graph is
    permanently excluded, even when max_graphs divides num_graphs."""
    epoch = (step * max_graphs) // cfg.num_graphs
    idx0 = (step * max_graphs + epoch) % cfg.num_graphs
    graphs = [make_graph(cfg, (idx0 + i) % cfg.num_graphs)
              for i in range(max_graphs)]
    batch, _ = pack_graphs(graphs, node_budget, edge_budget, max_graphs)
    return batch


def compute_average_nodes_and_edges(dataset, round_val: bool = True):
    """Paper API: gnnb.compute_average_nodes_and_edges."""
    n = float(np.mean([g.num_nodes for g in dataset]))
    e = float(np.mean([g.num_edges for g in dataset]))
    return (round(n), round(e)) if round_val else (n, e)


def compute_median_nodes_and_edges(dataset, round_val: bool = True):
    """Paper API: gnnb.compute_median_nodes_and_edges."""
    n = float(np.median([g.num_nodes for g in dataset]))
    e = float(np.median([g.num_edges for g in dataset]))
    return (round(n), round(e)) if round_val else (n, e)


def compute_average_degree(dataset):
    """Paper API: gnnb.compute_average_degree, the mean over graphs of
    edges per node."""
    return float(np.mean([g.num_edges / max(g.num_nodes, 1)
                          for g in dataset]))
