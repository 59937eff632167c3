"""The trace reduction on a hand-made Chrome trace, the wrappers' install
and removal, and the traced readers; and, on a card, a traced stretch of
the render traffic (marked ``cuda``: it decides inside whether a card is
there)."""

import types

import pytest
import torch

from benchmark import trace as TR
from benchmark.readers import idle, kernel_count, kernel_roofline, span


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def sample():
    return [
        ev("user_annotation", "bench::window", 0, 100),
        ev("user_annotation", "bench::a:bin", 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        ev("user_annotation", "bench::a:outer", 40, 30, tid=2),
        ev("user_annotation", "bench::a:inner", 45, 10, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 47, 1, tid=2, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 1, tid=2, correlation=3),
        ev("user_annotation", "bench::count", 80, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 81, 1, correlation=4),
        ev("cpu_op", "aten::item", 85, 14),
        ev("kernel", "void bin_kernel<1>(int)", 20, 10, tid=7, correlation=1),
        ev("kernel", "inner_kernel", 50, 5, tid=7, correlation=2),
        ev("gpu_memset", "Memset", 62, 3, tid=7, correlation=3),
        ev("kernel", "reduce", 82, 2, tid=8, correlation=4),
    ]


def test_trace_attribution_and_idle():
    t = TR.Trace(sample())
    assert t.window_us == 100
    assert t.device_us(frozenset(["a:bin"])) == 10
    assert t.device_us(frozenset(["a:outer"])) == 8
    assert t.device_us(frozenset(["a:inner"])) == 5
    assert t.device_us(frozenset(["a:outer"]), ["inner"]) == 5
    assert t.kernel_count() == 2          # the count span's kernel is out
    busy, gaps = t.busy()
    assert busy == 18 and gaps[0] == (0, 20) and gaps[-1] == (65, 100)
    b = t.breakdown()
    assert b["device_ops"][0] == ["bin_kernel<1>", pytest.approx(10e-6)]
    gaps = dict(b["idle_gaps"])
    # Gaps 0-20, 30-50, 55-62, 65-100, named at their middles.
    assert gaps == {"bench::a:bin": pytest.approx(20e-6),
                    "bench::a:outer": pytest.approx(27e-6),
                    "bench::count": pytest.approx(35e-6)}


def test_readers_on_the_sample():
    t = TR.Trace(sample())
    ctx = types.SimpleNamespace(trace=t, units=2, peak_bytes=0, wall_s=1e-4,
                                records=[
        ("a:outer", {"kind": "segment", "m": 1000, "n": 10})])
    assert span.read({"wrap": ["a:bin"]}, ctx) == pytest.approx(0.005)
    assert span.read({"wrap": ["a:none"]}, ctx) is None
    assert kernel_count.read({}, ctx) == 1
    assert idle.read({}, ctx) == pytest.approx(82.0)
    from benchmark.bounds import segment_bound
    assert kernel_roofline.read(
        {"wrap": ["a:outer"], "kernels": None}, ctx) == pytest.approx(
        100 * segment_bound(1000, 10) * 1e3 / 8)


def test_wrappers_restore_and_keep_launch_counts():
    import rtgs_tpu_torch.ops.peel as peel

    orig = peel.segment_rows_cuda
    before = orig.launches
    tr = TR.Tracer(["rtgs_tpu_torch.ops.peel:segment_rows_cuda"], {})
    with tr.installed("cpu"):
        assert peel.segment_rows_cuda is not orig
        peel.segment_rows_cuda.launches += 2
    assert peel.segment_rows_cuda is orig and orig.launches == before + 2
    orig.launches = before


@pytest.mark.cuda
def test_traced_stretch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import run as H

    cell = H.load_cell("render1m_orbit_d16")
    cell["config_data"]["scene"]["n"] = 200_000
    cell["traced_units"] = 3
    out = H.run_cell(cell, 5, 1.0, True, torch.device("cuda", 0))
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert 0 < m["peel_fwd_roofline.render"]["value"] <= 100
    assert m["binning_ms.render"]["value"] > 0
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
