"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): ``param_counts`` and ``model_flops`` for the ten
archs and every applicable shape; ``analyse_record`` of one synthetic
record gives the reference's terms times the ratio of the two packages'
constants (H100 against v5e), and the same MODEL/HLO ratio and roofline
fraction; ``fits`` holds arguments plus temporaries against 80e9 B with
nothing halved; ``markdown_table`` has the reference's rows, the
SKIPPED ones included; the collective term is null on one card."""
import json

import pytest
import torch

from repro import roofline as R
from repro.configs.registry import get_config as ref_config
from repro_torch import roofline as T
from repro_torch.configs.common import SHAPES, applicable_shapes
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.kernels import _cost

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_counts_and_model_flops_equal_the_references(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert T.param_counts(cfg) == R.param_counts(rcfg)
    shapes = applicable_shapes(cfg)
    assert shapes == R.applicable_shapes(rcfg)
    for shape in shapes:
        assert T.model_flops(cfg, shape) == R.model_flops(rcfg, shape)


def test_constants_are_the_cards():
    assert T.PEAK_FLOPS == _cost.TC_BF16_FLOPS_PER_S == 989e12
    assert T.HBM_BW == _cost.HBM_BYTES_PER_S == 3.35e12
    assert _cost.HBM_BYTES == 80e9 and T.LINK_BW is None
    assert T.PEAK_BY_DTYPE["float32"] == _cost.FP32_FLOPS_PER_S == 67e12


def _records(ok=True, **mem):
    memory = {"argument_size_in_bytes": 6e9, "temp_size_in_bytes": 9e9,
              **mem}
    common = dict(arch="qwen3-8b", shape="train_4k", mesh="16x16",
                  variant="auto", ok=ok, n_devices=256, memory=memory)
    ref = dict(common, hlo_dot_flops=3.1e14, hlo_dot_bytes=2.2e11,
               collective_bytes=0, collective_bytes_tpu=0, compile_s=1.0)
    port = dict(common, dtype="bfloat16", dot_flops=3.1e14,
                kernel_flops=0.0, dot_bytes=2.2e11, kernel_bytes=0.0,
                collective_bytes=None, trace_s=1.0)
    return port, ref


def test_analyse_record_scales_the_references_terms():
    port, ref = _records()
    c, r = T.analyse_record(port), R.analyse_record(ref)
    assert c.compute_s == pytest.approx(r.compute_s * R.PEAK_FLOPS
                                        / T.PEAK_FLOPS, rel=1e-12)
    assert c.memory_s == pytest.approx(r.memory_s * R.HBM_BW / T.HBM_BW,
                                       rel=1e-12)
    assert c.model_flops == r.model_flops
    assert c.flops_ratio == pytest.approx(r.flops_ratio, rel=1e-12)
    assert c.roofline_fraction == pytest.approx(r.roofline_fraction,
                                                rel=1e-12)
    assert c.hbm_gb == r.hbm_gb == 15.0
    assert c.dominant == r.dominant == "compute"
    assert c.mitigation == r.mitigation
    assert c.collective_s is None and r.collective_s == 0.0
    assert c.step_s == c.compute_s


def test_fits_halves_nothing():
    """The reference judged 4e9 + 22e9 / 2 < 16e9 a fit, though 26e9 is
    not (CPU XLA's bf16 upcast); the port holds the whole 26e9 against
    80e9, and 70e9 + 20e9 is no fit though half the temporaries would
    be."""
    port, ref = _records(argument_size_in_bytes=4e9, temp_size_in_bytes=22e9)
    assert R.analyse_record(ref).fits and T.analyse_record(port).fits
    port, _ = _records(argument_size_in_bytes=70e9, temp_size_in_bytes=20e9)
    assert not T.analyse_record(port).fits


def test_fp32_records_take_the_fp32_peak():
    port, _ = _records()
    port["dtype"] = "float32"
    assert T.analyse_record(port).compute_s == pytest.approx(
        3.1e14 / 67e12, rel=1e-12)


def test_kernel_work_joins_the_terms():
    port, _ = _records()
    port.update(kernel_flops=1e14, kernel_bytes=1e11, upper_bound=True)
    c = T.analyse_record(port)
    assert c.compute_s == pytest.approx(4.1e14 / T.PEAK_FLOPS, rel=1e-12)
    assert c.memory_s == pytest.approx(3.2e11 / T.HBM_BW, rel=1e-12)
    assert c.upper_bound and c.kernel_flops_chip == 1e14


def test_failed_record():
    port, ref = _records(ok=False)
    port["error"] = ref["error"] = "RuntimeError: boom"
    c, r = T.analyse_record(port), R.analyse_record(ref)
    assert not c.ok and c.error == r.error and c.compute_s == 0.0


def test_markdown_table_has_the_references_rows(tmp_path):
    port, ref = _records()
    assert T.skipped_cells() == R.skipped_cells()
    for rec, name in ((port, "port"), (ref, "ref")):
        d = tmp_path / name
        d.mkdir()
        (d / "a.json").write_text(json.dumps(rec))
        bad = dict(rec, shape="decode_32k", ok=False, error="X: y")
        (d / "b.json").write_text(json.dumps(bad))
    mine = T.markdown_table(T.load_cells(str(tmp_path / "port")), "16x16")
    theirs = R.markdown_table(R.load_cells(str(tmp_path / "ref")), "16x16")

    def firsts(md):
        return [tuple(x.strip() for x in ln.split("|")[1:4])
                for ln in md.splitlines()[2:]]
    rows, ref_rows = firsts(mine), firsts(theirs)
    assert [r[:2] for r in rows] == [r[:2] for r in ref_rows]
    assert [r for r in rows if "SKIPPED" in r[2]] == \
        [r for r in ref_rows if "SKIPPED" in r[2]]
    assert rows[0][2] == "FAILED: X: y" == ref_rows[0][2]
    assert mine.splitlines()[:2] == theirs.splitlines()[:2]
    assert "| null (null) |" in mine
    assert len(mine.splitlines()) == 2 + 2 + len(T.skipped_cells())
    assert SHAPES.keys() == {"train_4k", "prefill_32k", "decode_32k",
                             "long_500k"}


def test_roofline_of_a_dry_run_record():
    """A reduced cell traced by the dry run goes through the roofline."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen3-8b", "train_4k", reduced=True, seq=32,
                          batch=2)
    c = T.analyse_record(json.loads(json.dumps(rec)))
    assert c.ok and c.mesh == "1" and c.n_devices == 1
    assert c.compute_s == pytest.approx(
        (rec["dot_flops"] + rec["kernel_flops"]) / T.PEAK_FLOPS)
    assert c.model_flops == 0.0     # a cut cell has no 6 N D
    assert c.fits and c.collective_s is None
