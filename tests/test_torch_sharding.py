"""The port's sharding rules over a declared mesh shape
(``repro_torch.distributed.sharding``) against the reference's
(``repro.distributed.sharding``) on a ``_FakeMesh``-style object, as
``tests/test_distributed.py`` uses: the rule tables, ``auto_preset``,
``resolve_axis`` and ``spec_for`` for every arch x {train, prefill,
decode} x {single pod, multi-pod}, and ``spec_for`` over every leaf of
every arch's plan (``plan_pspecs``) under every preset on 16x16 and
2x16x16."""
import numpy as np
import pytest
import torch

from repro.configs.common import SHAPES as REF_SHAPES
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import get_config as ref_config
from repro.distributed import sharding as RS
from repro.models import lm as ref_lm
from repro_torch.configs.common import SHAPES
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.nn import param as prm

torch.set_num_threads(1)

KINDS = ("train", "prefill", "decode")


class _FakeMesh:
    """A mesh as the reference's rules read it: names and a device
    array's shape, no devices."""

    def __init__(self, axis_names, shape):
        self.axis_names = axis_names
        self.devices = np.empty(shape)


def meshes(multi_pod: bool) -> tuple:
    port = make_production_mesh(multi_pod=multi_pod)
    return port, _FakeMesh(port.axis_names, port.shape)


def ref_spec(spec) -> tuple:
    return tuple(spec)


def test_rule_tables_are_the_references():
    assert list(S.RULE_PRESETS) == list(RS.RULE_PRESETS)
    for name, table in S.RULE_PRESETS.items():
        assert table == RS.RULE_PRESETS[name], name
    assert S.DEFAULT_RULES == RS.DEFAULT_RULES


def test_production_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape, one.name) == (("data", "model"),
                                                     (16, 16), "16x16")
    assert (two.axis_names, two.shape, two.name) == (
        ("pod", "data", "model"), (2, 16, 16), "2x16x16")
    assert S.num_devices(one) == 256 and S.num_devices(two) == 512
    assert S.batch_axes(one) == RS.batch_axes(_FakeMesh(one.axis_names,
                                                        one.shape))
    assert S.batch_axes(two) == ("pod", "data")
    assert S.num_devices(S.SINGLE_CARD) == 1


def _dims() -> list:
    """Dim sizes a rule meets: the shapes' batches and sequences, head
    and width counts that do and do not divide 16, 1."""
    out = {1, 2, 8, 12, 24, 40, 64, 96, 128, 4096, 151936}
    for info in SHAPES.values():
        out |= {info["batch"], info["seq"]}
    return sorted(out)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("multi_pod", (False, True))
def test_preset_and_axes_equal_the_references(arch, multi_pod):
    assert list(ARCHS) == list(REF_ARCHS) and SHAPES == REF_SHAPES
    cfg, rcfg = get_config(arch), ref_config(arch)
    mesh, fake = meshes(multi_pod)
    for kind in KINDS:
        preset = S.auto_preset(cfg, kind, multi_pod)
        assert preset == RS.auto_preset(rcfg, kind, multi_pod)
        rules = S.RULE_PRESETS[preset]
        for logical in list(rules) + [None, "unknown"]:
            for dim in _dims():
                assert S.resolve_axis(logical, rules, mesh, dim) == \
                    RS.resolve_axis(logical, rules, fake, dim), (
                        kind, logical, dim)
        # the step's batch specs (reference steps._batch_io_specs)
        for info in SHAPES.values():
            for axes, shape in (
                    (("batch", None), (info["batch"], info["seq"])),
                    (("batch", None, None), (info["batch"], info["seq"],
                                             cfg.d_model)),
                    (("batch", "act_seq", "embed"),
                     (info["batch"], info["seq"], cfg.d_model))):
                assert S.spec_for(axes, shape, mesh, rules) == ref_spec(
                    RS.spec_for(axes, shape, fake, rules))


def _walk(port, ref, path=()):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            yield from _walk(port[k], ref[k], path + (k,))
    else:
        yield path, port, ref


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("multi_pod", (False, True))
def test_plan_specs_equal_the_references(arch, multi_pod):
    mesh, fake = meshes(multi_pod)
    plan, rplan = lm.model_plan(get_config(arch)), \
        ref_lm.model_plan(ref_config(arch))
    n = 0
    for name, rules in S.RULE_PRESETS.items():
        port = S.plan_pspecs(plan, mesh, rules)
        ref = RS.plan_pspecs(rplan, fake, rules)
        for path, spec, rspec in _walk(port, ref):
            assert spec == ref_spec(rspec), (name, path)
            n += 1
    assert n == 5 * len(prm.leaves(plan))


def test_shards_count_the_named_axes():
    mesh = make_production_mesh(multi_pod=True)
    assert S.shards((None, None), mesh) == 1
    assert S.shards(("data", None), mesh) == 16
    assert S.shards((("pod", "data"), "model"), mesh) == 512
    spec = S.spec_for(("embed", "mlp"), (4096, 12288), mesh, S.FSDP_RULES)
    assert spec == (("data", "model"), None)
    assert S.shards(spec, mesh) == 256


def test_mesh_shape_checks_its_rank():
    with pytest.raises(ValueError):
        S.MeshShape(("data", "model"), (16,))
