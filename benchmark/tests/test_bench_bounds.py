"""The benchmark's frozen copy of the roofline arithmetic gives what the
original in ``chip_smoke.py`` gives, on sample launch shapes at K = 16 (the
original's constant depth), but for the sweeps' operations, which count
only the work an exact result needs: their bytes are the original's, and
their bound never exceeds the original's. The original is read from its
source text, not imported: nothing under ``benchmark/`` imports
``chip_smoke``."""

import ast
import pathlib

import pytest

from benchmark import bounds

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAMES = {"HBM_BPS", "F32_OPS", "F64_OPS", "SWEEP_F64", "SHADE_F32", "DEPTH",
         "bound", "peel_bound", "segment_bound"}


def original():
    """The original's constants and functions, executed on their own."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    keep = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in NAMES:
            keep.append(node)
        elif isinstance(node, ast.Assign):
            targets = {getattr(t, "id", None) for t in node.targets} | {
                getattr(e, "id", None) for t in node.targets
                if isinstance(t, ast.Tuple) for e in t.elts}
            if targets & NAMES:
                keep.append(node)
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "chip_smoke.py",
                 "exec"), ns)
    return ns


SHAPES = [
    dict(t=1020, c=3712, p=256, n=1_000_001, live=1_764_239,
         winners=3_775_520),
    dict(t=768, c=1664, p=256, n=100_001, live=216_145, winners=1_052_069),
    dict(t=960, c=1664, p=256, n=100_001, live=216_145, winners=2_000_000),
]


SWEEPS = ["keys_sid", "peel_fwd", "peel_topk_fwd"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["peel_bwd", "peel_topk_bwd"])
def test_peel_bound_matches_original(kind, shape):
    ns = original()
    assert ns["DEPTH"] == 16
    assert bounds.peel_bound(kind, dict(shape, k=16)) == pytest.approx(
        ns["peel_bound"](kind, shape)[0], rel=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", SWEEPS)
def test_sweep_bytes_match_original(kind, shape):
    """With no operations counted on either side, the two give the same
    time: the bytes are unchanged."""
    ns = original()
    ns["SWEEP_F64"] = 0
    ns["SHADE_F32"] = {k: 0 for k in ns["SHADE_F32"]}
    ours = bounds.peel_bound(kind, dict(shape, k=16, needed=0, winners=0))
    assert ours == pytest.approx(ns["peel_bound"](kind, shape)[0],
                                 rel=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", SWEEPS)
def test_sweep_bound_counts_needed_work(kind, shape):
    """Every live pair needed reads at most the original (which charged the
    float64 chain to each); fewer needed pairs never read more."""
    ns = original()
    full = dict(shape, k=16, needed=shape["live"] * shape["p"])
    ours = bounds.peel_bound(kind, full)
    assert ours <= ns["peel_bound"](kind, shape)[0] * (1 + 1e-12)
    assert bounds.peel_bound(kind, dict(full, needed=full["needed"] // 4)) \
        <= ours
    assert bounds.peel_bound(kind, dict(shape, k=16)) == pytest.approx(ours)


def test_needed_pairs_from_chunk_bounds():
    """A pixel needs the live candidates of the chunks whose lower bound is
    at or below its K-th entry depth; +inf needs them all."""
    import torch

    cand = torch.tensor([[0, 1, 2, -1]], dtype=torch.int32)   # chunks of 2
    lb = torch.tensor([[0.5, 2.0, float("inf")]])
    t1_last = torch.tensor([[1.0, float("inf"), 2.0]])
    assert int(bounds.needed_pairs(cand, lb, t1_last)) == 2 + 3 + 3


@pytest.mark.parametrize("m,n", [(216_135, 100_001), (3_812_951, 1_000_001),
                                 (1, 1)])
def test_segment_bound_matches_original(m, n):
    assert bounds.segment_bound(m, n) == pytest.approx(
        original()["segment_bound"](m, n)[0], rel=1e-12)


def test_launch_shapes_from_calls():
    """Each ``*_launch`` reads T, C, P, K and the counts from the call."""
    import torch

    cand = torch.tensor([[0, 1, -1, -1], [2, -1, -1, -1]], dtype=torch.int32)
    packed = torch.zeros(4, 64)
    pix = torch.zeros(2, 8, 24)
    slots = torch.tensor([[[0] * 8, [-1] * 8]] * 2, dtype=torch.int32)

    def side(fn, *xs):
        return fn(*xs)

    s = bounds.peel_fwd_launch((packed, cand, None, pix, 2), {},
                               (None, None, slots), side)
    assert (s["t"], s["c"], s["p"], s["k"], s["n"]) == (2, 4, 8, 2, 4)
    assert int(s["live"]) == 3 and int(s["winners"]) == 16
    assert "needed" not in s        # every live pair against each pixel
    s = bounds.peel_bwd_launch((packed, cand, None, pix, slots, None, None,
                                2), {}, None, side)
    assert s["k"] == 2 and int(s["winners"]) == 16
    lb = torch.tensor([[0.0, 5.0, 9.0], [0.0, 0.0, 9.0]])  # chunks of 2
    t1 = torch.full((2, 2, 8), 1.0)
    s = bounds.keys_launch((packed, cand, None, lb, pix, 2), {},
                           (t1, slots), side)
    assert s["k"] == 2 and int(s["live"]) == 3 and int(s["winners"]) == 16
    assert int(s["needed"]) == (2 + 1) * 8     # tile 0's second chunk not
    s = bounds.segment_launch((torch.zeros(5, 64), None, 7), {}, None, side)
    assert bounds.launch_ms(s) == bounds.segment_bound(5, 7)
