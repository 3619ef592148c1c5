"""The redesigned CSR segment aggregation (one walk per segment, a set of
aggs in one launch) and segment softmax (a warp per run of segments,
the run staged in shared memory), against the JAX package.

On the CPU the wrappers run their kernels' plain versions. Held here:

* ``segment_geometry`` covers every output exactly once (``coverage``
  replays the kernel's index arithmetic) for the shapes the serving path
  launches and for adversarial ones, and picks the launch the design
  note describes at the served shapes;
* the multi-agg plain path (``aggregations.segment_aggregates``, one
  ``ops.segment_aggregate`` call with a tuple) for every tuple the model
  uses and for all six aggs, per agg against the JAX
  ``segment_aggregate_v2_pallas`` in interpret mode at
  ``test_torch_kernels``'s tolerance (atol 1e-5 plus rtol 2e-6, exact
  for min/max), and bit for bit against the single-agg calls;
* the softmax's plain version against the JAX ``segment_softmax_pallas``
  in interpret mode at ``test_torch_softmax``'s tolerance (atol 1e-6,
  rtol 1e-5) on the streams that stress the kernel's runs: hubs longer
  than ``LONG``, a hub on a run's edge, +-1e4, -inf and all -inf
  segments; the hub's fold in the kernel's 32 parts replayed step by
  step, bit for bit, and its weights a function of its own edge list; and
  a replay of the kernel's run / chunk schedule;
* the model's pooling and PNA towers, one launch each, give the bits of
  the per-agg calls they replace.

The CUDA tests need a card and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_aggregate.kernel import segment_aggregate_v2_pallas
from repro.kernels.segment_softmax.kernel import segment_softmax_pallas
from repro_torch.core import aggregations as TA
from repro_torch.core import convs as TC
from repro_torch.kernels import _build, _cost
from repro_torch.kernels.segment_aggregate import kernel as SK
from repro_torch.kernels.segment_aggregate import ops as SO
from repro_torch.kernels.segment_aggregate import ref as SR
from repro_torch.kernels.segment_softmax import kernel as SMK
from repro_torch.kernels.segment_softmax import ops as SMO
from repro_torch.kernels.segment_softmax import ref as SMR

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 2e-6                 # test_torch_kernels.py
SOFTMAX_ATOL, SOFTMAX_RTOL = 1e-6, 1e-5   # test_torch_softmax.py
EDGE_BLOCK = 32
POOLING = ("sum", "mean", "max")        # add / mean / max pooling
MODEL_TUPLES = (POOLING, TC.PNA_AGGS, SR.AGGS)
STORAGE = ("float32", "bfloat16", "int8")
SMS = 132


# ------------------------------------------------ the launch geometry --
def _check_geometry(s, f, rows, elem_bytes, sms):
    g = SK.segment_geometry(s, f, rows, elem_bytes, sms)
    cov = SK.coverage(g, s, f)
    assert cov.shape == (s, f) and (cov == 1).all(), g
    assert g.lanes_per_row & (g.lanes_per_row - 1) == 0
    assert 1 <= g.lanes_per_row <= 32
    assert g.cols_per_lane * elem_bytes <= 16
    assert g.cols_per_lane <= SK.MAX_COLS_PER_LANE
    assert max(f, 1) % g.cols_per_lane == 0
    assert g.rows_per_warp % g.rows_at_once == 0
    assert g.blocks == -(-g.warps // 8)
    return g


# (S, rows): pooling over 32 / 256 / 1024 qm9 graphs a batch, the edge
# messages of the 1024-graph batch by destination, one segment, one
# segment of 3000 rows, many short segments
SERVED = ((32, 872), (256, 6920), (1024, 27656), (27656, 55304))
ADVERSARIAL = ((1, 1), (1, 3000), (3, 3000), (301, 4001), (97, 1009),
               (100_000, 100_000))


@pytest.mark.parametrize("f", (1, 3, 11, 40, 64, 128, 257))
@pytest.mark.parametrize("s,rows", SERVED + ADVERSARIAL)
def test_segment_geometry_covers_every_output_once(s, rows, f):
    """fp32, bf16 and int8 rows on the H100's 132 SMs, and on one SM
    (where a warp walks many segment groups in series)."""
    for elem_bytes, sms in ((4, SMS), (2, SMS), (1, SMS), (4, 1)):
        _check_geometry(s, f, rows, elem_bytes, sms)


def test_segment_geometry_of_the_served_calls():
    """Pooling at 32 graphs: column groups give more warps; pooling at
    1024 graphs (~27 nodes a graph): every row of a segment in flight at
    once; edge messages at F = 128: one 16-byte load a lane; at F = 11
    several segments share a warp."""
    small = _check_geometry(32, 64, 872, 4, SMS)
    assert small.col_groups >= 2 and small.warps >= 64
    pool = _check_geometry(1024, 64, 27656, 4, SMS)
    assert SK.rows_in_flight(pool.cols_per_lane, 4) >= 27
    wide = _check_geometry(27656, 128, 55304, 4, SMS)
    assert wide.cols_per_lane == 4 and wide.passes == 1
    assert _check_geometry(27656, 128, 55304, 2, SMS).cols_per_lane == 8
    narrow = _check_geometry(27656, 11, 55304, 4, SMS)
    assert narrow.rows_at_once >= 2 and narrow.lanes_per_row == 16
    # a misaligned view caps the columns a lane
    assert SK.segment_geometry(27656, 128, 55304, 4, SMS,
                               max_cols=1).cols_per_lane == 1


def test_segment_geometry_refuses_bad_shapes():
    for args in ((0, 4, 2, 4, SMS), (4, -1, 2, 4, SMS), (4, 4, -1, 4, SMS),
                 (4, 4, 2, 3, SMS), (4, 4, 2, 4, 0)):
        with pytest.raises(ValueError):
            SK.segment_geometry(*args)


def test_agg_slots_pack_each_agg_in_its_place():
    """4 bits per agg code (sum, mean, min, max, var, std): the agg's
    output slot, 0xF when it is not asked for."""
    assert SK.agg_slots(("sum",)) == 0xFFFFF0
    assert SK.agg_slots(("mean", "min", "max", "std")) == 0x3F210F
    assert SK.agg_slots(POOLING) == 0xFF2F10
    for bad in ((), ("sum", "sum"), ("median",), "median"):
        with pytest.raises(ValueError):
            SR.agg_set(bad)


# ---------------------------------------- the multi-agg plain path --
def _stream(seed, e=211, s=41, f=11, extreme=False):
    """Rows by a non-contiguous id stream with -1 / >= S ids, an empty
    and a one-row segment, a segment of up to 60 rows."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, s - 2, e).astype(np.int32)
    seg[:4] = [-1, s, s + 5, -9]
    seg[4] = s - 1                          # one row
    seg[seg == 3] = 4                       # segment 3 empty
    seg[rng.choice(np.arange(5, e), min(60, e // 2), replace=False)] = 7
    msg = (rng.standard_normal((e, f)) * 3).astype(np.float32)
    if extreme:
        msg[10, :4] = [1e30, -1e30, np.inf, -np.inf]
        msg[11, 4:6] = [-3e38, 3e38]
    return rng, msg, seg


def _storage_pair(x32, storage, rng):
    if storage == "int8":
        xi = rng.integers(-128, 128, x32.shape).astype(np.int8)
        return jnp.asarray(xi), torch.from_numpy(xi)
    if storage == "bfloat16":
        return jnp.asarray(x32).astype(jnp.bfloat16), \
            torch.from_numpy(x32).to(torch.bfloat16)
    return jnp.asarray(x32), torch.from_numpy(x32)


def _assert_close(agg, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if agg in ("min", "max"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("aggs", MODEL_TUPLES,
                         ids=("pooling", "pna", "all six"))
def test_multi_agg_plain_matches_pallas_v2_per_agg(aggs, storage):
    extreme = storage == "float32"
    rng, msg, seg = _stream(0, extreme=extreme)
    mj, mt = _storage_pair(msg, storage, rng)
    s, f = 41, msg.shape[1]
    got = TA.segment_aggregates(aggs, mt, torch.from_numpy(seg), s)
    assert got.shape == (s, len(aggs) * f) and got.dtype == torch.float32
    for i, agg in enumerate(aggs):
        part = got[:, i * f:(i + 1) * f]
        want = segment_aggregate_v2_pallas(mj, jnp.asarray(seg), s,
                                           agg=agg, edge_block=EDGE_BLOCK,
                                           interpret=True)
        _assert_close(agg, part.numpy(), want)
        single = TA.segment_aggregate(agg, mt, torch.from_numpy(seg), s)
        assert torch.equal(part.view(torch.int32), single.view(torch.int32))


@pytest.mark.parametrize("aggs", MODEL_TUPLES,
                         ids=("pooling", "pna", "all six"))
def test_multi_agg_ops_call_is_one_call_and_the_plain_concatenation(aggs):
    """``ops.segment_aggregate`` with a tuple: the single-agg plain
    results side by side, under a valid mask and a shared CSR; the
    one-hot schedule gives the same bits, one call per agg."""
    rng, msg, seg = _stream(1, e=150, s=23, f=6)
    valid = torch.from_numpy(rng.random(150) < 0.8)
    mt, st = torch.from_numpy(msg), torch.from_numpy(seg)
    csr = TA.build_csr(st, 23, valid)
    got = SO.segment_aggregate(mt, csr.perm, csr.offsets, agg=aggs)
    want = torch.cat([SR.segment_aggregate_ref(mt, csr.perm, csr.offsets,
                                               agg=a) for a in aggs], 1)
    assert torch.equal(got, want)
    assert torch.equal(TA.segment_aggregates(aggs, mt, st, 23, valid,
                                             csr=csr), got)
    with TA.aggregation_scope(gather_mode="onehot"):
        assert torch.equal(TA.segment_aggregates(aggs, mt, st, 23, valid),
                           got)


def test_multi_agg_repeated_agg_is_folded_once():
    _, msg, seg = _stream(2, e=90, s=13, f=5)
    mt, st = torch.from_numpy(msg), torch.from_numpy(seg)
    got = TA.segment_aggregates(("sum", "max", "sum"), mt, st, 13)
    one = TA.segment_aggregates(("sum", "max"), mt, st, 13)
    assert torch.equal(got, torch.cat([one, one[:, :5]], 1))
    with pytest.raises(ValueError):
        TA.segment_aggregates(("sum", "median"), mt, st, 13)


def test_multi_agg_empty_stream_gives_zeros_without_launch():
    before = SO.segment_aggregate.launches
    z = SO.segment_aggregate(torch.zeros((0, 4)),
                             torch.zeros(0, dtype=torch.int32),
                             torch.zeros(6, dtype=torch.int32),
                             agg=TC.PNA_AGGS)
    assert z.shape == (5, 16) and not z.any()
    assert SO.segment_aggregate.launches == before


def test_multi_agg_cuda_branch_launches_once(monkeypatch):
    """The wrapper's CUDA branch, reached on the CPU by patching
    ``runs_plain`` and the launch: one launch for a set of aggs, the
    launch given the tuple."""
    seen = []

    def launch(messages, perm, offsets, *, agg):
        seen.append(agg)
        return SR.segment_aggregate_ref(messages, perm, offsets, agg=agg)

    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(SO, "segment_aggregate_cuda", launch)
    monkeypatch.setattr(SO.segment_aggregate, "launches", 0)
    _, msg, seg = _stream(3, e=60, s=9, f=4)
    csr = TA.build_csr(torch.from_numpy(seg), 9)
    with torch.inference_mode():
        out = SO.segment_aggregate(torch.from_numpy(msg), csr.perm,
                                   csr.offsets, agg=TC.PNA_AGGS)
    assert out.shape == (9, 16) and seen == [TC.PNA_AGGS]
    assert SO.segment_aggregate.launches == 1


def test_multi_agg_work_reads_the_rows_once():
    """``segment_multi_work``: the rows and their ids once, an output per
    agg; a fold per element for each of sum (mean shares it), min, max,
    four for the one Welford state of var and std."""
    _, msg, seg = _stream(4, e=70, s=11, f=8)
    mt = torch.from_numpy(msg)
    csr = TA.build_csr(torch.from_numpy(seg), 11)
    n_valid = int(csr.offsets[-1])
    one, _ = _cost.segment_work(mt, csr.perm, csr.offsets, agg="mean")
    moved, ops = _cost.segment_work(mt, csr.perm, csr.offsets,
                                    agg=TC.PNA_AGGS)
    assert (moved, ops) == _cost.segment_multi_work(
        mt, csr.perm, csr.offsets, TC.PNA_AGGS)
    assert moved == one + 3 * 4 * 11 * 8
    assert ops == (1 + 1 + 1 + 4) * n_valid * 8
    _, pool = _cost.segment_work(mt, csr.perm, csr.offsets, agg=POOLING)
    assert pool == 2 * n_valid * 8
    _, both = _cost.segment_work(mt, csr.perm, csr.offsets,
                                 agg=("var", "std"))
    assert both == 4 * n_valid * 8


# ------------------------------------------- the model's call sites --
def _packed_batch(conv):
    from repro.configs import gnn as JCfg
    from repro_torch.configs import gnn as TCfg
    from repro_torch.core import gnn_model as TG
    from repro_torch.data import pipeline as TP
    from repro_torch.launch import serve as TS
    from repro_torch.nn import param as tprm
    from test_torch_model import port_cfg

    cfg = port_cfg(JCfg.config(conv, reduced=True))
    params = tprm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ds = TCfg.DATASETS["qm9"]
    graphs = [TP.make_graph(ds, i) for i in range(8)]
    nb, eb = TS.budgets(8, ds)
    batch, _ = TP.pack_graphs(graphs, nb, eb, 8)
    return TG, cfg, params, TG.packed_to_device(batch, "cpu")


@pytest.mark.parametrize("conv", ("gcn", "pna"))
def test_model_output_keeps_the_bits_of_the_per_agg_calls(conv,
                                                          monkeypatch):
    """``apply_packed`` with the pooling and (PNA) the towers as one call
    each gives the bits of the same model with one call per agg."""
    TG, cfg, params, batch = _packed_batch(conv)
    with torch.inference_mode():
        got = TG.apply_packed(params, cfg, batch)

    def per_agg(aggs, messages, seg_ids, num_segments, valid=None, *,
                csr=None, precision=None):
        return torch.cat([TA.segment_aggregate(a, messages, seg_ids,
                                               num_segments, valid, csr=csr,
                                               precision=precision)
                          for a in aggs], dim=-1)

    from repro_torch.core import pooling as TP
    monkeypatch.setattr(TA, "segment_aggregates", per_agg)
    monkeypatch.setattr(TP, "segment_aggregates", per_agg)
    with torch.inference_mode():
        want = TG.apply_packed(params, cfg, batch)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ------------------------------------------------------ the softmax --
def _jax_softmax(z, seg, n):
    return np.asarray(segment_softmax_pallas(
        jnp.asarray(z), jnp.asarray(seg), n, edge_block=EDGE_BLOCK,
        interpret=True))


def _softmax_streams():
    """(label, z, seg, n): two hubs longer than ``LONG`` in one run of 32
    segments, a hub on the edge of two runs, +-1e4, -inf on
    valid edges, an all -inf segment, ids -1 and >= n, S not a multiple
    of 32."""
    rng = np.random.default_rng(17)
    n = 75
    e = 3 * SMR.LONG + 900
    seg = rng.integers(0, n, e).astype(np.int32)
    seg[rng.choice(e, SMR.LONG + 40, replace=False)] = 3      # hub
    seg[rng.choice(e, 2 * SMR.LONG, replace=False)] = 12      # hub
    seg[rng.choice(e, SMR.LONG + 7, replace=False)] = 31      # run edge
    seg[seg == 5] = 6                                          # empty
    seg[:5] = [-1, n, n + 4, -3, 40]
    z = (rng.standard_normal(e) * 6).astype(np.float32)
    z[::61] = 1e4
    z[1::67] = -1e4
    z[2::43] = -np.inf
    z[seg == 20] = -np.inf                                     # all -inf
    yield "hubs", z, seg, n
    # one segment of several thousand edges, nothing else
    z1 = (rng.standard_normal(3000) * 4).astype(np.float32)
    z1[::97] = -np.inf
    yield "one hub", z1, np.zeros(3000, np.int32), 1
    # every logit -inf
    yield "all -inf", np.full(300, -np.inf, np.float32), \
        rng.integers(0, 40, 300).astype(np.int32), 40


@pytest.mark.parametrize("case", list(range(3)),
                         ids=("hubs", "one hub", "all -inf"))
def test_softmax_plain_matches_pallas_on_the_kernels_streams(case):
    label, z, seg, n = list(_softmax_streams())[case]
    got = TA.segment_softmax(torch.from_numpy(z), torch.from_numpy(seg),
                             n).numpy()
    want = _jax_softmax(z, seg, n)
    np.testing.assert_allclose(got, want, atol=SOFTMAX_ATOL,
                               rtol=SOFTMAX_RTOL, err_msg=label)
    assert np.isfinite(got).all()
    assert np.array_equal(got == 0, want == 0)


def test_softmax_hub_is_folded_in_the_kernels_parts():
    """A segment of more than ``LONG`` edges: its i-th edge goes to part
    (i // 4) % 32, each part folds in stream order, the parts merge in
    order; replayed here one scalar step at a time, bit for bit."""
    rng = np.random.default_rng(23)
    n = SMR.LONG * 3 + 45
    z = torch.from_numpy((rng.standard_normal(n) * 5).astype(np.float32))
    z[7::31] = float("-inf")
    seg = torch.zeros(n, dtype=torch.int32)
    csr = TA.build_csr(seg, 1)
    m, l = SMR.segment_softmax_stats_ref(z, csr.perm, csr.offsets)
    parts = []
    for j in range(SMR.PARTS):
        pm, pl = torch.tensor(SMR.NEG_INF), torch.tensor(0.0)
        for i in range(n):
            if (i // SMR.RUN) % SMR.PARTS == j:
                m_new = torch.maximum(pm, z[i])
                pl = pl * torch.exp(pm - m_new) + torch.exp(z[i] - m_new)
                pm = m_new
        parts.append((pm, pl))
    hm, hl = parts[0]
    for pm, pl in parts[1:]:
        m_new = torch.maximum(hm, pm)
        hl = hl * torch.exp(hm - m_new) + pl * torch.exp(pm - m_new)
        hm = m_new
    assert torch.equal(m[0], hm) and torch.equal(l[0], hl)
    # a segment of LONG edges keeps the serial fold
    short = z[:SMR.LONG]
    csr = TA.build_csr(torch.zeros(SMR.LONG, dtype=torch.int32), 1)
    m, l = SMR.segment_softmax_stats_ref(short, csr.perm, csr.offsets)
    sm, sl = torch.tensor(SMR.NEG_INF), torch.tensor(0.0)
    for v in short:
        m_new = torch.maximum(sm, v)
        sl = sl * torch.exp(sm - m_new) + torch.exp(v - m_new)
        sm = m_new
    assert torch.equal(m[0], sm) and torch.equal(l[0], sl)


def test_softmax_hub_weights_depend_on_its_own_edges_alone():
    """The split is by position in the segment's own edge list, so
    reordering the other segments' edges (a partitioned run's stream)
    leaves the hub's weights bitwise equal."""
    rng = np.random.default_rng(29)
    seg = rng.integers(0, 9, 900).astype(np.int32)
    seg[rng.choice(900, 400, replace=False)] = 4          # the hub
    z = (rng.standard_normal(900) * 5).astype(np.float32)
    w = TA.segment_softmax(torch.from_numpy(z), torch.from_numpy(seg),
                           9).numpy()
    keep = seg == 4
    assert keep.sum() > SMR.LONG
    order = np.concatenate([rng.permutation(np.flatnonzero(~keep))[:200],
                            np.flatnonzero(keep),
                            rng.permutation(np.flatnonzero(~keep))[200:]])
    w2 = TA.segment_softmax(torch.from_numpy(z[order]),
                            torch.from_numpy(seg[order]), 9).numpy()
    assert np.array_equal(w2[200:200 + keep.sum()], w[keep])


def test_softmax_run_schedule_writes_every_edge_once():
    """The kernel's schedule replayed: runs of 32 segments, a lane each,
    staged 128 entries at a time (a chunk that holds no short segment's
    entry is skipped); a short segment's entries written by its lane
    from the chunks, a long one's by the whole warp, 4 a lane in steps of
    128; the tail by every thread. Every CSR entry is written once,
    every tail entry zeroed once."""
    label, z, seg, n = next(_softmax_streams())
    csr = TA.build_csr(torch.from_numpy(seg), n)
    off = csr.offsets.numpy().astype(np.int64)
    lengths = off[1:] - off[:-1]
    assert (lengths > SMR.LONG).sum() >= 2
    e, stage, runs = seg.size, 128, -(-n // 32)
    written = np.zeros(e, np.int64)
    for run in range(runs):
        s = run * 32 + np.arange(32)
        beg = off[np.minimum(s, n)]
        end = off[np.minimum(s + 1, n)]
        long = end - beg > SMR.LONG
        for k0 in range(beg[0], end[-1], stage):
            lo, hi = np.maximum(beg, k0), np.minimum(end, k0 + stage)
            if not (~long & (lo < hi)).any():
                continue
            for i in np.flatnonzero(~long):
                written[lo[i]:hi[i]] += 1
        for i in np.flatnonzero(long):
            for j in range(32):
                for c0 in range(beg[i] + j, end[i], 128):
                    written[c0:min(c0 + 128, end[i]):32] += 1
    threads = -(-runs // 4) * 128
    tail = np.arange(off[n], e)
    for t in range(threads):
        written[tail[t::threads]] += 1
    assert (written == 1).all()


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: launches the segment-aggregate "
                    "and segment-softmax kernels")
    return torch.device("cuda")


@pytest.mark.parametrize("storage", STORAGE)
def test_cuda_multi_agg_is_the_single_agg_kernel_bit_for_bit(cuda_device,
                                                             storage):
    rng, msg, seg = _stream(5, e=3001, s=301, f=40, extreme=True)
    _, mt = _storage_pair(msg, storage, rng)
    mt = mt.to(cuda_device)
    csr = TA.build_csr(torch.from_numpy(seg).to(cuda_device), 301)
    singles = {a: SK.segment_aggregate_cuda(mt, csr.perm, csr.offsets,
                                            agg=a) for a in SR.AGGS}
    for aggs in MODEL_TUPLES + (("var", "std"), ("max", "min")):
        got = SK.segment_aggregate_cuda(mt, csr.perm, csr.offsets, agg=aggs)
        torch.cuda.synchronize()
        for i, a in enumerate(aggs):
            part = got[:, i * 40:(i + 1) * 40].contiguous()
            assert torch.equal(part.view(torch.int32),
                               singles[a].view(torch.int32)), (aggs, a)
    want = SR.segment_aggregate_ref(mt, csr.perm, csr.offsets, agg=SR.AGGS)
    got = SK.segment_aggregate_cuda(mt, csr.perm, csr.offsets, agg=SR.AGGS)
    for i, a in enumerate(SR.AGGS):
        _assert_close(a, got[:, i * 40:(i + 1) * 40].cpu(),
                      want[:, i * 40:(i + 1) * 40].cpu())


def test_cuda_every_geometry_gives_the_same_bits(cuda_device):
    rng, msg, seg = _stream(6, e=2000, s=97, f=64)
    mt = torch.from_numpy(msg).to(cuda_device)
    csr = TA.build_csr(torch.from_numpy(seg).to(cuda_device), 97)
    base = SK.segment_aggregate_cuda(mt, csr.perm, csr.offsets,
                                     agg=TC.PNA_AGGS)
    for sms in (1, 8, 132):
        for cap in (1, 2, 4):
            g = SK.segment_geometry(97, 64, 2000, 4, sms, max_cols=cap)
            got = SK.segment_aggregate_cuda(mt, csr.perm, csr.offsets,
                                            agg=TC.PNA_AGGS, geometry=g)
            assert torch.equal(got.view(torch.int32),
                               base.view(torch.int32)), g


def test_cuda_softmax_on_the_kernels_streams(cuda_device):
    for label, z, seg, n in _softmax_streams():
        zt = torch.from_numpy(z).to(cuda_device)
        csr = TA.build_csr(torch.from_numpy(seg).to(cuda_device), n)
        before = SMO.segment_softmax.launches
        got = SMO.segment_softmax(zt, csr.perm, csr.offsets)
        assert SMO.segment_softmax.launches == before + 1
        want = SMR.segment_softmax_ref(zt, csr.perm, csr.offsets)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), label
        assert torch.equal(got == 0, want == 0), label
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-7), label
