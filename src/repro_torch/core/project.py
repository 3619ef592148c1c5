"""Project: GNNBuilder's push-button accelerator-generation flow (paper
§III, Listing 1) on an NVIDIA H100, the port of ``repro.core.project``.

Stage mapping, as in the reference:
  gen_hw_model()             -> the specialised inference programs: the
                                padded per-graph ``_fn`` and the packed
                                ``_fn_packed``, each with the project's
                                kernel generation and tiles bound in
  gen_testbench()            -> dataset graphs + fp32 reference outputs
  build_and_run_testbench()  -> the program over the testbench graphs:
                                MAE against the references, measured
                                runtime, and the packed drain's graphs/s
  run_synthesis()            -> the synthesis report: roofline latency,
                                FLOPs, bytes and memory footprints from a
                                counting pass over the programs, plus the
                                packed program's modeled graphs/s
All artifacts (config.json, testbench.npz, tb_data.json, report.json)
land in ``build_dir``, with the reference's keys.

The knobs bind as in the reference: ``agg_backend="pallas"`` runs the
kernels ``gather_mode`` picks at the given ``edge_block``/``node_block``
tiles (``aggregations.aggregation_scope``), and only there may the
resident layer stack engage (a legal residency plan, ``fusion_depth >
1``, no fixed-point hook); ``agg_backend="xla"``, the default, runs the
port's default CSR kernels and ignores the tiles and the gather mode,
as the reference's XLA path does. ``precision`` (a name from
``quantization.PRECISIONS`` or a resolved ``PrecisionPolicy``) selects
the per-layer datapath width, as in the reference: int8 grids are
calibrated on the testbench graphs before the testbench runs, and the
fp32 reference outputs pin an explicit fp32 policy. The legacy
fixed-point datapath (``float_or_fixed="fixed"``) runs too.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import time
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import aggregations as A
from repro_torch.core import convs as Cv
from repro_torch.core import gnn_model as G
from repro_torch.core import quantization as Q
from repro_torch.data import pipeline as P
from repro_torch.device import l2_cache_bytes, resolve_device
from repro_torch.kernels import _cost
from repro_torch.nn import param as prm

AGG_BACKENDS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class H100Target:
    """Hardware constants of one NVIDIA H100 SXM: the ``fpga_part``
    analogue, in place of the reference's ``TPUTarget``."""
    name: str = "h100-sxm"
    # fp32 outside the tensor cores, the rate of the port's fp32
    # datapath (NVIDIA H100 SXM data sheet; chip_smoke.FP32_FLOPS_PER_S)
    peak_flops: float = 67e12
    hbm_bw: float = 3.35e12          # B/s, HBM3 (data sheet)
    link_bw: float = 450e9           # B/s, NVLink 4, one direction
    hbm_bytes: float = 80e9          # HBM3 (data sheet)
    # L2 (data sheet; L2_cache_size reads 52428800 on the card): the
    # residency budget where no card is present
    l2_bytes: float = 50 * 2 ** 20
    # time per (node tile x edge tile) step of the one-hot kernels: the
    # one-hot launches of a full-width GCN batch at 1024 graphs/batch
    # (two gathers, three poolings, default tiles), their time over their
    # steps, as chip_smoke.py phase 6 prints it (NVIDIA H100 80GB HBM3,
    # power limit 700.00 W; 9.404e-9 s for the kernels that swept the
    # stream once per node tile): what makes the tile knobs observable to
    # the modeled latency. The kernels now bucket the stream once, so
    # their time no longer grows with the steps; the reference's step
    # formula below is kept, priced at this reading
    kernel_step_overhead: float = 5.6083e-10


def _tree_leaves(tree: dict) -> list:
    """Tensor leaves in sorted key order (the reference's tree order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _tree_leaves(v) if isinstance(v, dict) else [v]
    return out


def _flat(tree: dict) -> torch.Tensor:
    """Every leaf of a tree, flattened in sorted key order, on the CPU
    as fp32."""
    return torch.cat([t.reshape(-1).cpu().to(torch.float32)
                      for t in _tree_leaves(tree)])


def _zero_params(plan: dict, device: torch.device) -> dict:
    return {k: _zero_params(v, device) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=torch.float32, device=device)
            for k, v in plan.items()}


# matrix-vector products that torch.utils.flop_counter has no formula for
_VECTOR_PRODUCTS = (torch.ops.aten.mv, torch.ops.aten.dot)
_COUNTED_TAGS = tuple(getattr(torch.Tag, t) for t in ("pointwise", "reduction")
                      if hasattr(torch.Tag, t))


class _OpCounter(TorchDispatchMode):
    """The counting pass of ``run_synthesis``: FLOPs, bytes and peak live
    bytes of every aten operation that runs inside it. FLOPs:
    ``torch.utils.flop_counter``'s formulas for the matrix products (two
    per multiply-add for matrix-vector products), the output's element
    count for pointwise operations and reductions, nothing for index and
    layout operations. Bytes: inputs plus outputs of every operation that
    is not a view. A call into a kernel wrapper is priced by its
    function's work (``kernels._cost``) and its own operations are not
    counted. Live bytes: the outputs of the counted operations and
    kernels while they are referenced. ``by_op``: the bytes of each
    operation (its ATen name; ``kernels`` for the kernel calls)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0
        self.by_op = collections.Counter()
        self.live = 0
        self.peak = 0
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def kernel(self, moved: int, ops: float, out) -> None:
        self.flops += ops
        self.bytes += moved
        self.by_op["kernels"] += moved
        self._track(out)

    def _track(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet in _VECTOR_PRODUCTS:
            self.flops += 2.0 * args[0].numel()
        elif any(tag in func.tags for tag in _COUNTED_TAGS):
            self.flops += sum(t.numel() for t in outs)
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            moved = _cost.nbytes(*ins, *outs)
            self.bytes += moved
            self.by_op[str(packet)] += moved
            held = {t.untyped_storage().data_ptr() for t in ins}
            for t in outs:
                if t.untyped_storage().data_ptr() not in held:
                    self._track(t)
        return out


class Project:
    def __init__(self, name: str, model_cfg: G.GNNModelConfig, task: str,
                 build_dir: str, dataset_cfg=None, max_nodes: int = 600,
                 max_edges: int = 600, num_nodes_guess: float = 18,
                 num_edges_guess: float = 38, degree_guess: float = 2.1,
                 float_or_fixed: str = "float", fpx: Q.FPX = Q.FPX(32, 16),
                 target: H100Target = H100Target(), n_jobs: int = 1,
                 seed: int = 0, batch_graphs: int = 32,
                 node_budget: int | None = None,
                 edge_budget: int | None = None,
                 edge_block: int = 128, node_block: int = 128,
                 agg_backend: str = "xla", dataflow: str | None = None,
                 precision=None, num_shards: int = 1,
                 gather_mode: str = "dma", fusion_depth: int = 1,
                 partition: int = 1, device="cuda"):
        self.name = name
        # the dataflow override and the dataset degree flow into the
        # per-layer transform/aggregate planner (convs.resolve_dataflow);
        # precision, a name or a resolved PrecisionPolicy, selects the
        # per-layer datapath width
        cfg_updates = {"avg_degree": float(degree_guess)}
        if dataflow is not None:
            cfg_updates["gnn_dataflow"] = dataflow
        if isinstance(precision, str):
            cfg_updates["gnn_precision"] = precision
        self.cfg = dataclasses.replace(model_cfg, **cfg_updates)
        # resolved once per project; build_and_run_testbench calibrates
        # the int8 grids on the testbench graphs before it runs
        self.policy = G.resolve_policy(
            self.cfg, None if isinstance(precision, str) else precision)
        self.task = task
        self.build_dir = build_dir
        self.dataset_cfg = dataset_cfg or P.GraphDataConfig(
            max_nodes=max_nodes, max_edges=max_edges,
            node_feat_dim=model_cfg.graph_input_feature_dim,
            edge_feat_dim=model_cfg.graph_input_edge_dim)
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.num_nodes_guess = num_nodes_guess
        self.num_edges_guess = num_edges_guess
        self.degree_guess = degree_guess
        self.float_or_fixed = float_or_fixed
        self.fpx = fpx
        self.target = target
        self.seed = seed
        # packed GraphBatch budgets: ~batch_graphs average graphs with
        # 1.5x slack, instead of batch_graphs * max_nodes of padding
        self.batch_graphs = batch_graphs
        self.node_budget = node_budget or P.size_budget(batch_graphs,
                                                        num_nodes_guess)
        self.edge_budget = edge_budget or P.size_budget(batch_graphs,
                                                        num_edges_guess)
        # the one-hot kernels' tiles and the kernel generation
        if agg_backend not in AGG_BACKENDS:
            raise ValueError(f"agg_backend must be one of {AGG_BACKENDS}, "
                             f"got {agg_backend!r}")
        if gather_mode not in A.GATHER_MODES:
            raise ValueError(f"gather_mode must be one of "
                             f"{A.GATHER_MODES}, got {gather_mode!r}")
        self.edge_block = edge_block
        self.node_block = node_block
        self.agg_backend = agg_backend
        self.gather_mode = gather_mode
        # multi-layer residency: fusion_depth > 1 asks for the resident
        # stack; convs.residency_plan decides legality at gen_hw_model
        if fusion_depth < 1:
            raise ValueError(f"fusion_depth must be >= 1, "
                             f"got {fusion_depth}")
        self.fusion_depth = fusion_depth
        self.residency = None        # ResidencyPlan, set by gen_hw_model
        self.residency_engaged = False
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        if partition < 1:
            raise ValueError(f"partition must be >= 1, got {partition}")
        self.partition = partition
        self.device = resolve_device(device)
        self._fn = None
        self._fn_packed = None
        self.params = None
        self.counted = None          # run_synthesis's counting passes
        os.makedirs(build_dir, exist_ok=True)

    # ------------------------------------------------------- generation --
    def init_params(self, generator: torch.Generator | None = None):
        """Random parameters from ``generator`` (default: seeded by the
        project's ``seed``), on the project's device."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        self.params = prm.init_params(self.cfg, generator, self.device)
        return self.params

    def _quant(self) -> Q.FPX | None:
        return self.fpx if self.float_or_fixed == "fixed" else None

    def _knobs(self) -> tuple:
        """(gather_mode, edge_block, node_block) the programs bind."""
        if self.agg_backend == "pallas":
            return self.gather_mode, self.edge_block, self.node_block
        return "dma", None, None

    def _l2_bytes(self) -> int:
        return l2_cache_bytes(self.device) or int(self.target.l2_bytes)

    def gen_hw_model(self):
        """Build the specialised inference programs (codegen analogue)
        and write config.json."""
        cfg = self.cfg
        quant = self._quant()
        knobs = self._knobs()
        policy = self.policy

        cast = {}           # the weights cast for the policy, once per params

        def bound(apply_fn):
            # the project's kernel generation and tiles hold for each call
            # of its programs and nowhere else
            def fn(params, batch):
                if cast.get("params") is not params:
                    cast.update(params=params, tree=G.cast_for_policy(
                        params, cfg, policy))
                with A.aggregation_scope(*knobs), torch.no_grad():
                    return apply_fn(cast["tree"], batch)
            return fn

        self.residency = Cv.residency_plan(
            G.layer_dims(cfg), self.node_budget, cfg.gnn_conv,
            self.fusion_depth, edge_budget=self.edge_budget,
            l2_bytes=self._l2_bytes())
        resident = (self.residency.legal and self.fusion_depth > 1
                    and self.agg_backend == "pallas" and quant is None)
        self.residency_engaged = resident
        self._fn = bound(lambda p, el: G.apply(p, cfg, el, quant, policy))
        if resident:
            depth = self.residency.depth
            built = {}          # the padded weight stacks, once per params

            def packed(p, b):
                if built.get("params") is not p:
                    built.update(params=p, stacks=G.resident_stacks(
                        p, cfg, depth, policy))
                return G.apply_packed_resident(p, cfg, b, None, policy,
                                               fusion_depth=depth,
                                               stacks=built["stacks"])
            self._fn_packed = bound(packed)
        else:
            self._fn_packed = bound(
                lambda p, b: G.apply_packed(p, cfg, b, quant, policy))
        with open(os.path.join(self.build_dir, "config.json"), "w") as f:
            json.dump({"name": self.name,
                       "model": dataclasses.asdict(cfg),
                       "quant": str(self.fpx),
                       "float_or_fixed": self.float_or_fixed,
                       # the resolved (possibly calibrated) policy the
                       # programs run
                       "precision": policy.describe(),
                       "max_nodes": self.max_nodes,
                       "max_edges": self.max_edges,
                       "batch_graphs": self.batch_graphs,
                       "node_budget": self.node_budget,
                       "edge_budget": self.edge_budget,
                       "edge_block": self.edge_block,
                       "node_block": self.node_block,
                       "agg_backend": self.agg_backend,
                       "gather_mode": self.gather_mode,
                       "fusion_depth": self.fusion_depth,
                       # the planner's verdict, and whether the resident
                       # packed program engaged (it also needs the pallas
                       # backend and no fixed-point hook)
                       "residency": dataclasses.asdict(self.residency),
                       "residency_engaged": resident,
                       "num_shards": self.num_shards,
                       "partition": self.partition,
                       "dataflow": cfg.gnn_dataflow,
                       "dataflow_per_layer": [
                           Cv.resolve_dataflow(cfg.conv_cfg(i))
                           for i in range(cfg.gnn_num_layers)]},
                      f, indent=1, default=str)
        return self._fn

    def _zero_graph(self) -> dict:
        n, e, c = self.max_nodes, self.max_edges, self.dataset_cfg
        return G.packed_to_device({
            "node_feat": np.zeros((n, c.node_feat_dim), np.float32),
            "edge_index": np.zeros((e, 2), np.int32),
            "edge_feat": np.zeros((e, c.edge_feat_dim), np.float32),
            "num_nodes": np.int32(0)}, self.device)

    def _zero_packed(self) -> dict:
        nb, eb, gm = self.node_budget, self.edge_budget, self.batch_graphs
        c = self.dataset_cfg
        return G.packed_to_device({
            "node_feat": np.zeros((nb, c.node_feat_dim), np.float32),
            "node_graph_id": np.zeros((nb,), np.int32),
            "edge_index": np.zeros((eb, 2), np.int32),
            "edge_feat": np.zeros((eb, c.edge_feat_dim), np.float32),
            "edge_graph_id": np.zeros((eb,), np.int32),
            "graph_valid": np.zeros((gm,), bool),
            "graph_num_nodes": np.zeros((gm,), np.int32),
            "num_graphs": np.int32(0)}, self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -------------------------------------------------------- testbench --
    def gen_testbench(self, num_graphs: int = 64):
        """Export dataset graphs + fp32 reference outputs (the paper's
        binary testbench data). The reference runs the default kernels,
        never the project's knobs or fixed-point hook, and an explicit
        fp32 policy, so that ``cfg.gnn_precision`` cannot reach it."""
        ds = [P.make_graph(self.dataset_cfg, i) for i in range(num_graphs)]
        if self.params is None:
            self.init_params()
        fp32 = Q.resolve_policy("fp32", self.cfg.gnn_num_layers)
        with torch.no_grad():
            refs = [G.apply(self.params, self.cfg, self._graph_to_el(g),
                            None, fp32).cpu().numpy()
                    for g in ds]
        np.savez(os.path.join(self.build_dir, "testbench.npz"),
                 refs=np.stack(refs), n=num_graphs)
        self._tb_graphs = ds
        self._tb_refs = refs
        return len(ds)

    def _graph_to_el(self, g: P.Graph) -> dict:
        return G.packed_to_device({"node_feat": g.node_feat,
                                   "edge_index": g.edge_index,
                                   "edge_feat": g.edge_feat,
                                   "num_nodes": np.int32(g.num_nodes)},
                                  self.device)

    def calibrate(self, num_graphs: int = 8) -> Q.PrecisionPolicy:
        """Max-abs calibrate the project's int8 grids on a packed batch of
        the first ``num_graphs`` testbench graphs, then regenerate the
        programs (and config.json) with the calibrated policy. Returns the
        policy; fp32 and bf16 have no grids and return it unchanged."""
        if not self.policy.needs_calibration:
            return self.policy
        if self.params is None:
            self.init_params()
        graphs = getattr(self, "_tb_graphs", None) \
            or [P.make_graph(self.dataset_cfg, i) for i in range(num_graphs)]
        batch, _ = P.pack_graphs(graphs[:num_graphs], self.node_budget,
                                 self.edge_budget, self.batch_graphs)
        self.policy = G.calibrated_policy(
            self.params, self.cfg, G.packed_to_device(batch, self.device),
            self.policy)
        self.gen_hw_model()          # the programs and config.json anew
        return self.policy

    def build_and_run_testbench(self, packed: bool = True) -> dict:
        """Run the generated program on every testbench graph; report the
        MAE against the fp32 references and the measured runtime (host
        clock around each call, ending in ``torch.cuda.synchronize`` on
        the card). With ``packed`` the same graphs also drain through the
        packed program (graphs/s); ``num_shards > 1`` adds
        ``tb["sharded"]``. A low-precision policy (int8 grids calibrated
        first) and the fixed-point path also report the output and weight
        quantization error."""
        if self.params is None:
            self.init_params()
        if self.policy.needs_calibration:
            self.calibrate()
        if self._fn is None:
            self.gen_hw_model()
        params = self.params
        if self.float_or_fixed == "fixed":
            params = Q.quantize_tree(params, self.fpx)
        els = [self._graph_to_el(g) for g in self._tb_graphs]
        for el in els:                                  # warm-up, build
            self._fn(params, el)
        self._sync()
        maes, times, outs = [], [], []
        for el, ref in zip(els, self._tb_refs):
            t0 = time.perf_counter()
            out = self._fn(params, el)
            self._sync()
            times.append(time.perf_counter() - t0)
            outs.append(out.cpu().numpy())
            maes.append(float(np.mean(np.abs(outs[-1] - ref))))
        tb = {"mae": float(np.mean(maes)),
              "mean_runtime_ms": float(np.mean(times) * 1e3),
              "p50_runtime_ms": float(np.median(times) * 1e3),
              "n_graphs": len(self._tb_graphs),
              "loop_graphs_per_s": 1.0 / max(float(np.mean(times)), 1e-12),
              "quant": str(self.fpx) if self.float_or_fixed == "fixed"
              else "float32",
              "precision": self.policy.name}
        if not self.policy.is_fp32 or self.float_or_fixed == "fixed":
            tb["quant_error"] = {"output": Q.error_stats(
                np.stack(outs), np.stack(self._tb_refs))}
        if self.float_or_fixed == "fixed":
            tb["quant_error"]["weights"] = Q.quant_error_stats(
                _flat(self.params), self.fpx)
        elif any(lp.compute == "int8" for lp in self.policy.layers) \
                or self.policy.head.compute == "int8":
            # the weights the datapath quantizes, each against its own
            # grid: the conv weights of each layer and the head (the
            # skip projections stay fp32)
            def cast_part(tree):
                return {"convs": tree["convs"], "mlp": tree.get("mlp", {})}
            cast = G.cast_for_policy(self.params, self.cfg, self.policy)
            tb["quant_error"]["weights"] = Q.error_stats(
                _flat(cast_part(cast)), _flat(cast_part(self.params)))
        if packed:
            tb["packed"] = self._run_packed_testbench(params)
            if self.num_shards > 1:
                tb["sharded"] = self._run_sharded_testbench()
        with open(os.path.join(self.build_dir, "tb_data.json"), "w") as f:
            json.dump(tb, f, indent=1)
        return tb

    def _run_packed_testbench(self, params) -> dict:
        """Drain the testbench graphs through the packed program and
        compare against the per-graph fp32 references."""
        batches, dropped = P.pack_dataset(
            self._tb_graphs, self.node_budget, self.edge_budget,
            self.batch_graphs)
        dev_batches = [G.packed_to_device(b, self.device) for b in batches]
        for b in dev_batches:                           # warm-up, build
            self._fn_packed(params, b)
        self._sync()
        t0 = time.perf_counter()
        outs = [self._fn_packed(params, b) for b in dev_batches]
        self._sync()
        total_s = time.perf_counter() - t0
        refs = iter(r for g, r in zip(self._tb_graphs, self._tb_refs)
                    if P.graph_fits_budget(g, self.node_budget,
                                           self.edge_budget))
        maes, n_graphs = [], 0
        for b, out in zip(batches, outs):
            k = int(b["num_graphs"])
            out = out.cpu().numpy()
            if self.cfg.task == "graph":
                for i in range(k):
                    maes.append(float(np.mean(np.abs(out[i] - next(refs)))))
            else:    # node task: rows are packed node embeddings
                off = 0
                for i in range(k):
                    n = int(b["graph_num_nodes"][i])
                    ref = next(refs)[:n]
                    maes.append(float(np.mean(
                        np.abs(out[off:off + n] - ref))))
                    off += n
            n_graphs += k
        return {
            "mae": float(np.mean(maes)) if maes else float("nan"),
            "graphs_per_s": n_graphs / max(total_s, 1e-12),
            "mean_batch_ms": total_s / max(len(batches), 1) * 1e3,
            "n_batches": len(batches),
            "n_graphs": n_graphs,
            "n_dropped": len(dropped),
            "batch_graphs": self.batch_graphs,
            "node_budget": self.node_budget,
            "edge_budget": self.edge_budget,
        }

    def _run_sharded_testbench(self) -> dict:
        have = torch.cuda.device_count()
        if have < self.num_shards:
            return {"skipped": f"needs {self.num_shards} devices, have "
                               f"{have}",
                    "num_shards": self.num_shards}
        raise NotImplementedError(
            "sharded testbench drains: multi-device inference is not "
            "ported yet (ROADMAP queue 1 item 8)")

    # -------------------------------------------------------- synthesis --
    def _measure(self, fn, inputs) -> dict:
        """Run ``fn`` on zero parameters and ``inputs`` twice: first
        timed (wall clock, the kernel build included) with the device's
        peak allocation, then under the counting pass."""
        params = _zero_params(G.model_plan(self.cfg), self.device)
        cuda = self.device.type == "cuda"
        if cuda:
            self._sync()
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        t0 = time.perf_counter()
        fn(params, inputs)
        self._sync()
        first_s = time.perf_counter() - t0
        counter = _OpCounter()
        with counter, _cost.pricing(counter):
            fn(params, inputs)
        temp = torch.cuda.max_memory_allocated(self.device) - base if cuda \
            else counter.peak
        args = _cost.nbytes(*_tree_leaves(params), *inputs.values())
        return {"first_s": first_s, "flops": counter.flops,
                "bytes": counter.bytes, "bytes_by_op": dict(counter.by_op),
                "temp": int(temp), "args": args}

    def run_synthesis(self) -> dict:
        """Count the programs and emit the synthesis report: modeled
        roofline latency (the Vitis latency analogue) and memory
        footprints (the BRAM analogue), with the reference's keys.

        XLA's cost and memory analyses have no counterpart in PyTorch, so
        each program runs once on budget-shaped zero inputs (zero ids
        make every edge slot a valid 0 -> 0 edge and every node slot a
        node of graph 0, so the kernels are priced over the whole
        budget) under ``_OpCounter``, each kernel call priced by its
        function's work. ``compile_s`` is the wall time of the first run,
        the kernel build included. ``temp_bytes`` is
        ``torch.cuda.max_memory_allocated`` over that run beyond what was
        allocated before it on the card, or the counting pass's peak of
        live operation outputs on the CPU; ``arg_bytes`` is the
        parameters plus the input buffers. Every other term is the
        reference's arithmetic."""
        if self._fn is None:
            self.gen_hw_model()
        single = self._measure(self._fn, self._zero_graph())
        flops, bytes_ = single["flops"], float(single["bytes"])
        temp, args = single["temp"], single["args"]
        # utilization scaling with the parallelism factors: p_h * p_out
        # = 128 fills the datapath, p = 1 one lane group (the reference's
        # HLS II/unroll-factor analogue)
        p_eff = min(max(self.cfg.gnn_p_hidden * self.cfg.gnn_p_out, 1),
                    128) / 128
        eff_peak = self.target.peak_flops * p_eff
        # data-width scaling: the legacy fixed-point width moves w/32 of
        # the counted fp32 program's bytes. A precision policy is not
        # scaled here, unlike in the reference (whose cost analysis sees
        # fake-quant fp32): the counting pass prices every tensor and
        # kernel operand at its element size, so bf16 and int8 storage
        # already shows in the counted bytes
        width_scale = self.fpx.w / 32.0 \
            if self.float_or_fixed == "fixed" else 1.0
        latency = max(flops / eff_peak,
                      bytes_ * width_scale / self.target.hbm_bw)
        packed_m = self._measure(self._fn_packed, self._zero_packed())
        # the counting passes as measured (``bytes_by_op`` among them),
        # kept beside the report, whose keys are the reference's
        self.counted = {"single": single, "packed": packed_m}
        flops_p = packed_m["flops"]
        bytes_p = packed_m["bytes"] * width_scale
        # aggregation tile model (the reference's formula): grid steps
        # per conv layer, each paying the one-hot kernels' measured step
        # time. The one-hot schedule sweeps ceil(E/EB) x ceil(N/NB) steps;
        # ceil(E/EB) is the reference's DMA-kernel grid, kept as its
        # arithmetic though the port's CSR kernels have no edge tiles
        grid_steps = -(-self.edge_budget // self.edge_block)
        if self.gather_mode == "onehot":
            grid_steps *= -(-self.node_budget // self.node_block)
        agg_overhead_s = (self.cfg.gnn_num_layers * grid_steps
                          * self.target.kernel_step_overhead)
        # the reference's modeled gather FLOPs (convs.gather_compute_flops)
        # on the pallas backend: the one-hot schedule's dense contraction
        # is priced as the reference prices it
        gather_flops = 0.0
        if self.agg_backend == "pallas":
            feat = max(self.cfg.gnn_hidden_dim,
                       self.cfg.graph_input_feature_dim)
            gather_flops = self.cfg.gnn_num_layers \
                * Cv.gather_compute_flops(self.node_budget,
                                          self.edge_budget, feat,
                                          self.gather_mode,
                                          self.node_block)
        latency_p = max((flops_p + gather_flops) / eff_peak,
                        bytes_p / self.target.hbm_bw) + agg_overhead_s
        packed = {
            "latency_s": latency_p,
            "precision": self.policy.name,
            "compute_bytes": self.policy.compute_bytes,
            "agg_grid_steps": grid_steps,
            "agg_overhead_s": agg_overhead_s,
            "gather_mode": self.gather_mode,
            "gather_flops": gather_flops,
            "fusion_depth": self.fusion_depth,
            "residency_engaged": bool(self.residency_engaged),
            "edge_block": self.edge_block,
            "node_block": self.node_block,
            "flops": flops_p,
            "bytes_accessed": bytes_p,
            "batch_graphs": self.batch_graphs,
            "node_budget": self.node_budget,
            "edge_budget": self.edge_budget,
            "graphs_per_s": self.batch_graphs / max(latency_p, 1e-18),
            "per_graph_latency_s": latency_p / max(self.batch_graphs, 1),
            "compile_s": packed_m["first_s"],
        }
        # data-parallel sharded model: every device runs the per-shard
        # program concurrently; the wave adds the gather of the outputs
        # over the links
        if self.cfg.task == "graph":
            out_vals = self.batch_graphs * (self.cfg.mlp_head.out_dim
                                            if self.cfg.mlp_head else 1)
        else:
            out_vals = self.node_budget * self.cfg.gnn_output_dim
        gather_bytes = 0.0 if self.num_shards == 1 \
            else self.num_shards * out_vals * 4.0
        latency_sh = latency_p + gather_bytes / self.target.link_bw
        wave_graphs = self.num_shards * self.batch_graphs
        packed["sharded"] = {
            "num_shards": self.num_shards,
            "latency_s": latency_sh,
            "gather_bytes": gather_bytes,
            "wave_graphs": wave_graphs,
            "graphs_per_s": wave_graphs / max(latency_sh, 1e-18),
            "scaling_efficiency": (wave_graphs / max(latency_sh, 1e-18))
            / max(self.num_shards * packed["graphs_per_s"], 1e-18),
        }
        # intra-graph partitioned model: the balanced worst-case cut,
        # (P-1)/P of the per-device edge budget, exchanges halo rows at
        # every layer boundary (convs.halo_comm_bytes)
        feat_dim = max(self.cfg.gnn_hidden_dim,
                       self.cfg.graph_input_feature_dim)
        cut_model = (self.partition - 1) / self.partition \
            * self.edge_budget
        halo_bytes = Cv.halo_comm_bytes(cut_model, feat_dim,
                                        self.policy.compute_bytes,
                                        self.cfg.gnn_num_layers)
        comm_s = halo_bytes / self.target.link_bw
        latency_pt = latency_p + comm_s
        packed["partitioned"] = {
            "partition": self.partition,
            "modeled_cut_edges": cut_model,
            "halo_comm_bytes": halo_bytes,
            "comm_s": comm_s,
            "latency_s": latency_pt,
            "oversize_graphs_per_s": 1.0 / max(latency_pt, 1e-18),
            "padded_oracle_latency_s": latency_p * self.partition,
        }
        report = {
            "packed": packed,
            "latency_s": latency,
            "latency_ms": latency * 1e3,
            "flops": flops,
            "bytes_accessed": bytes_,
            "temp_bytes": temp,
            "arg_bytes": args,
            "hbm_total_bytes": temp + args,
            "fits_hbm": (temp + args) < self.target.hbm_bytes,
            "compile_s": single["first_s"],
            "target": self.target.name,
            "precision": self.policy.name,
        }
        with open(os.path.join(self.build_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=1)
        return report

    # paper-API alias
    run_vitis_hls_synthesis = run_synthesis
