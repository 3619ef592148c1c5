"""Convs that aggregate by max or min, as a user defines them:

* ``sage_max`` (``sage_min``), GraphSAGE with the max (min) aggregator,
  PyG's ``SAGEConv(aggr="max")``: x' = W_self x_v + b + W_neigh . max_u
  x_u. Max is not linear, so the neighbours are aggregated at the input
  width; the parameters are ``sage_plan``'s;
* ``gat_max``, GAT's attention with its weighted messages aggregated by
  max, PyG's ``GATConv(aggr="max")``: x' = W_self x_v + max_u alpha_uv (W
  x_u) + b, ``gat_plan``'s parameters. Its per-edge weights require grad,
  so it differentiates the gather's scale too.

Neither package registers them: ``registered`` adds them to the port's
registry (and, with ``jax=True``, to the JAX package's, each with its
own plans) for the block and removes them after, so no registry listener
sees them once it ends.
"""
import contextlib

CONVS = {"sage_max": "max", "sage_min": "min", "gat_max": "max"}
# the capability flags of a user conv: not reorderable (max is not
# linear), not resident, left out of the design-space exploration
CAPS = dict(dse=False)


def port_apply(agg: str):
    from repro_torch.core import aggregations as A
    from repro_torch.core import convs as C
    from repro_torch.nn.layers import linear

    def apply(params, g, x, cfg):
        src, dst = C.edge_endpoints(g)
        aggr = A.gather_aggregate(agg, x, src, dst, x.shape[0], g["valid_e"],
                                  csr=g.get("edge_csr"),
                                  precision=cfg.precision).to(x.dtype)
        return linear(params["w_self"], x) + linear(params["w_neigh"], aggr)
    return apply


def port_gat_apply(agg: str):
    import torch.nn.functional as F
    from repro_torch.core import aggregations as A
    from repro_torch.core import convs as C
    from repro_torch.nn.layers import linear, matmul

    def apply(params, g, x, cfg):
        src, dst = C.edge_endpoints(g)
        n = x.shape[0]
        h = matmul(x, params["w"]["w"])
        hf = h.float()
        logits = C._gather(matmul(hf, params["a_src"]), src) \
            + C._gather(matmul(hf, params["a_dst"]), dst)
        if "a_edge" in params:
            logits = logits + matmul(g["edge_feat"].float(),
                                     params["a_edge"]["w"].float())[:, 0]
        csr = g.get("edge_csr")
        alpha = A.segment_softmax(F.leaky_relu(logits, 0.2), dst, n,
                                  g["valid_e"], csr=csr)
        aggr = A.gather_aggregate(agg, h, src, dst, n, g["valid_e"], alpha,
                                  csr=csr, precision=cfg.precision)
        return linear(params["w_self"], x) + aggr.to(x.dtype) \
            + params["w"]["b"]
    return apply


def jax_gat_apply(agg: str):
    import jax
    import jax.numpy as jnp
    from repro.core import aggregations as A
    from repro.core import convs as C
    from repro.nn.layers import linear

    def apply(params, g, x, cfg):
        src, dst = C.edge_endpoints(g)
        n = x.shape[0]
        h = x @ params["w"]["w"]
        hf = h.astype(jnp.float32)
        logits = C._gather(hf @ params["a_src"].astype(jnp.float32), src) \
            + C._gather(hf @ params["a_dst"].astype(jnp.float32), dst)
        if "a_edge" in params:
            logits = logits + (g["edge_feat"].astype(jnp.float32)
                               @ params["a_edge"]["w"].astype(
                                   jnp.float32))[:, 0]
        alpha = A.segment_softmax(jax.nn.leaky_relu(logits, 0.2), dst, n,
                                  g["valid_e"])
        aggr = A.gather_aggregate(agg, h, src, dst, n, g["valid_e"], alpha,
                                  precision=cfg.precision)
        return linear(params["w_self"], x) + aggr.astype(x.dtype) \
            + params["w"]["b"]
    return apply


def jax_apply(agg: str):
    from repro.core import aggregations as A
    from repro.core import convs as C
    from repro.nn.layers import linear

    def apply(params, g, x, cfg):
        src, dst = C.edge_endpoints(g)
        aggr = A.gather_aggregate(agg, x, src, dst, x.shape[0], g["valid_e"],
                                  precision=cfg.precision)
        return linear(params["w_self"], x) \
            + linear(params["w_neigh"], aggr.astype(x.dtype))
    return apply


@contextlib.contextmanager
def registered(jax: bool = False):
    """The convs of ``CONVS`` registered for the block."""
    from repro_torch.core import convs as TC
    packages = [(TC, port_apply, port_gat_apply)]
    if jax:
        from repro.core import convs as JC
        packages.append((JC, jax_apply, jax_gat_apply))
    done = []
    try:
        for mod, sage, gat in packages:
            for name, agg in CONVS.items():
                if name.startswith("gat"):
                    mod.register_conv(name, mod.gat_plan, gat(agg),
                                      attention=True, **CAPS)
                else:
                    mod.register_conv(name, mod.sage_plan, sage(agg), **CAPS)
                done.append((mod, name))
        yield
    finally:
        for mod, name in reversed(done):
            mod.unregister_conv(name)
