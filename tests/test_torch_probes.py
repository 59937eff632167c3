"""The plain torch versions of the port's probe variants
(rtgs_tpu_torch.probes.kmicro, kprobe, lpprobe) against the bodies of the
JAX package's scripts (scripts/kmicro.py, scripts/kprobe.py,
scripts/lpprobe.py), loaded by path and left as they are.

kmicro's ten elementwise variants are plain jnp functions, defined inside
its main(): the test reads that dict literal out of the script's source and
evaluates it in the script's own namespace. Its kernel bodies run under a
pl.pallas_call(..., interpret=True) built here (the script's make_raw has
no interpret argument). ``roll_sub16`` uses pltpu.roll, which the CPU
interpreter may not have: if it fails there, the plain version is held
against a numpy statement of the same function.

Tolerances. Selections, copies and minima are exact. Products and chains
may contract to FMAs in XLA's CPU code: rtol 2e-6. Row sums run in another
order: rtol 1e-5. The port's entry depth is float64 rounded once where the
scripts' is f32 (its Δ cancels): on the test's wide splats t1 agrees to
rtol 1e-4 and a grazing ray may hit in one and miss in the other (99.8% of
the pixels must agree on that; images by tests/_utils.assert_images_close).
On the chunk body's random rows the f32 chain is worse conditioned: 97% of
the t1 within rtol 1e-4 and all within 5e-3, and its selection may differ
where two t1 tie in f32, so its slots must agree for 98% of the layers."""

import ast
import importlib.util
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.ops.peel import _counts as j_counts
from rtgs_tpu.ops.peel import _gather as j_gather
from rtgs_tpu.render import tiled as jtiled
from rtgs_tpu.render.binning import tile_candidates as j_tile_candidates
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu import gaussians as JG
from rtgs_tpu_torch.ops.peel import peel_fused_torch
from rtgs_tpu_torch.probes import kmicro, kprobe, lpprobe
from rtgs_tpu_torch.scene import random_scene_arrays
from tests._utils import assert_images_close

ROOT = pathlib.Path(__file__).resolve().parents[1]
T, P, C = 2, 256, 128
K = kmicro.K


def _load(name):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, ast.parse(path.read_text())


@pytest.fixture(scope="module")
def jmicro():
    return _load("kmicro")


def _main_dicts(tree):
    """name → dict-literal node, for the dicts assigned in main()."""
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return {n.targets[0].id: n.value for n in ast.walk(main)
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
            and isinstance(n.targets[0], ast.Name)}


def _jax_names(tree):
    """Every variant name of scripts/kmicro.py: the keys of its four dicts
    and the two added by subscript."""
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = [k.value for name, d in _main_dicts(tree).items()
             if name.endswith("variants") for k in d.keys]
    names += [n.targets[0].slice.value for n in ast.walk(main)
              if isinstance(n, ast.Assign)
              and isinstance(n.targets[0], ast.Subscript)
              and isinstance(n.targets[0].slice, ast.Constant)]
    return names


def _port_table():
    """TPU variant → the port's variants, from the table in the docstring
    of rtgs_tpu_torch.probes.kmicro."""
    table = {}
    for line in kmicro.__doc__.splitlines():
        if "->" in line and "TPU variant" not in line:
            left, right = line.split("->")
            table[left.strip()] = tuple(s.strip() for s in right.split(","))
    return table


PORT_OF = _port_table()
LAMBDAS = ("copy", "mult", "chain10", "div", "sqrt", "exp", "exp2",
           "exp_where", "min_reduce", "min_reduce_sub")
BODIES = {   # JAX variant → (body's name in the script, scratch shape)
    "any_when": ("_k_any_when", None), "any_when8": ("_k_any_when8", None),
    "fori16": ("_k_fori16", None),
    "fori128_tiny": ("_k_fori128_tiny", None),
    "dynslice_sub": ("_k_dynslice_sub", None),
    "argmin_pass": ("_k_argmin_pass", None),
    "matvec_ones": ("_k_matvec_ones", None),
    "roll_sub16": ("_k_roll_sub16", None),
    "loop13_static": ("_k_loop13_static", None),
    "loop13_dynslice": ("_k_loop13_dynslice", None),
    "concat144": ("_k_concat144", None), "merge16": ("_k_merge16", None),
    "merge16_loop": ("_k_merge16_loop", None),
    "bitonic16_loop": ("_k_bitonic16_loop", None),
    "loop13_anywhen": ("_k_loop13_anywhen", (8, 128)),
    "loop13_full": ("_k_loop13_full", (8, 128)),
    "bitonic16_scr": ("_k_bitonic16_scratch", (1, P, 96)),
    "chunkbody": ("_k_chunkbody", (1, P, 96)),
    "body_carry_bit": ("bitonic", None), "body_carry_arg": ("argmin", None),
}
EXACT = ("copy", "min_reduce", "min_reduce_sub", "roll_sub16")
SUMS = ("matvec_ones", "dynslice_sub", "loop13_static", "loop13_dynslice")


def _input(signed=False):
    x = kmicro.make_input(T, P, C, "cpu").numpy()
    return (x - 1.5).astype(np.float32) if signed else x


def _run_body(mod, jname, x):
    body, scratch = BODIES[jname]
    kernel = (mod._mk_chunkbody_carry(body) if jname.startswith("body_carry")
              else getattr(mod, body))
    call = pl.pallas_call(
        kernel, grid=(T,),
        in_specs=[pl.BlockSpec((1, P, C), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, P, C), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((T, P, C), jnp.float32),
        scratch_shapes=([pltpu.VMEM(scratch, jnp.float32)] if scratch
                        else []),
        interpret=True)
    return np.asarray(call(jnp.asarray(x)))


def test_variant_table_names_every_jax_variant(jmicro):
    _, tree = jmicro
    names = _jax_names(tree)
    assert len(names) == 30 and len(set(names)) == 30
    assert set(names) == set(PORT_OF) == set(LAMBDAS) | set(BODIES)
    ported = {p for ports in PORT_OF.values() for p in ports}
    assert ported == set(kmicro.VARIANTS)


@pytest.mark.parametrize("name", LAMBDAS)
def test_kmicro_lambda_matches_jax(jmicro, name):
    mod, tree = jmicro
    fns = eval(compile(ast.Expression(_main_dicts(tree)["variants"]),
                       "kmicro.variants", "eval"), vars(mod))
    x = _input()
    want = np.asarray(fns[name](jnp.asarray(x)))
    for port in PORT_OF[name]:
        got = kmicro.micro(port, torch.from_numpy(x)).numpy()
        if name in EXACT:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-6)


def _numpy_roll_sub16(x):
    v = x.copy()
    for _ in range(16):
        r = np.roll(v, 1, axis=1)
        v = np.where(v > r, r, v)
    return v


def _check_merge_state(got, want, x, wide):
    """``want``: a TPU body's output; ``got``: the port's 96-lane dump."""
    if wide:    # (t1, ord, payloads 1-4) in lanes 0:96
        np.testing.assert_array_equal(got[..., :2 * K], want[..., :2 * K])
        np.testing.assert_allclose(got[..., 2 * K:6 * K],
                                   want[..., 2 * K:6 * K], rtol=2e-6)
    else:       # t1 in 0:16, payload 1 in 16:32
        np.testing.assert_array_equal(got[..., :K], want[..., :K])
        np.testing.assert_allclose(got[..., 2 * K:3 * K],
                                   want[..., K:2 * K], rtol=2e-6)
    np.testing.assert_allclose(got[..., 6 * K:], want[..., 6 * K:],
                               rtol=2e-6)


def _check_chunkbody(got, want, wide):
    t1_g, t1_w = got[..., :K], want[..., :K]
    fin = np.isfinite(t1_w)
    assert (np.isfinite(t1_g) == fin).mean() > 0.999
    both = fin & np.isfinite(t1_g)
    rel = np.abs(t1_g[both] - t1_w[both]) / np.abs(t1_w[both])
    if rel.size:
        assert np.quantile(rel, 0.97) <= 1e-4 and rel.max() <= 5e-3, (
            np.quantile(rel, 0.97), rel.max())
    qa_g = got[..., 2 * K:3 * K]
    qa_w = want[..., 2 * K:3 * K] if wide else want[..., K:2 * K]
    if wide:
        same = (got[..., K:2 * K] == want[..., K:2 * K]) & both
        assert same.sum() >= 0.98 * both.sum()
    else:
        with np.errstate(invalid="ignore"):
            same = both & (np.abs(t1_g - t1_w) <= 1e-6 * np.abs(t1_w))
    ok = same & np.isfinite(qa_w) & np.isfinite(qa_g)
    np.testing.assert_allclose(qa_g[ok], qa_w[ok], rtol=1e-3, atol=1e-3)
    if wide:
        for ch in (3, 4, 5):
            np.testing.assert_allclose(
                got[..., ch * K:(ch + 1) * K][same],
                want[..., ch * K:(ch + 1) * K][same], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[..., 6 * K:], want[..., 6 * K:],
                               rtol=2e-6)
    return int(both.sum())


@pytest.mark.parametrize("name", sorted(BODIES))
def test_kmicro_body_matches_jax(jmicro, name):
    mod, _ = jmicro
    chunk = name in ("chunkbody", "body_carry_bit", "body_carry_arg")
    for signed in ((False, True) if chunk else (False,)):
        x = _input(signed)
        if name == "roll_sub16":
            try:
                want = _run_body(mod, name, x)
            except Exception:    # no pltpu.roll in the CPU interpreter
                want = _numpy_roll_sub16(x)
        else:
            want = _run_body(mod, name, x)
        for port in PORT_OF[name]:
            got = kmicro.micro(port, torch.from_numpy(x)).numpy()
            if chunk:
                hits = _check_chunkbody(got, want, wide=name == "chunkbody")
                assert (hits > 1000) == signed   # rays hit only when signed
            elif name in ("merge16_loop", "bitonic16_loop", "bitonic16_scr"):
                _check_merge_state(got, want, x, name == "bitonic16_scr")
            elif name in EXACT:
                np.testing.assert_array_equal(got, want)
            elif name == "merge16":
                np.testing.assert_array_equal(got[..., :2 * K],
                                              want[..., :2 * K])
                np.testing.assert_allclose(got, want, rtol=2e-6)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=1e-5 if name in SUMS else 2e-6)


# ----- kprobe and lpprobe, on one small scene -----

@pytest.fixture(scope="module")
def frame():
    """A small frame from the JAX package's binning: wide splats (scales
    0.05-0.2), so the f32 entry depth of the scripts is accurate."""
    fields = random_scene_arrays(1500, 1.0, (0.05, 0.2), seed=8)
    jg = JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    pos, rot, _, _ = orbit_camera_pose(0.4, 1.2, 4.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    jcam = camera_from_fov(pos, rot, (48, 32), 60.0)
    b = j_tile_candidates(jg, jcam, tile=(16, 16), max_candidates=384,
                          max_global=32)
    cand = b.candidates
    pad_c = (-cand.shape[1]) % 128
    cand = jnp.pad(cand, ((0, 0), (0, pad_c)), constant_values=-1)
    # One tile with no candidate at all: its state stays the initial one.
    cand = cand.at[-1].set(-1)
    packed = jtiled.pack_features(jtiled.precompute_features(jg, jcam))
    pix = jtiled._tile_pixel_features(jcam, (16, 16))
    gathered, _ = j_gather(packed, cand)
    return dict(packed=packed, cand=cand, pix=pix, gathered=gathered,
                counts=j_counts(cand))


def _port_inputs(frame):
    return (torch.from_numpy(np.array(frame["packed"])),
            torch.from_numpy(np.array(frame["cand"])),
            torch.from_numpy(np.array(frame["counts"]).astype(np.int32)),
            torch.from_numpy(np.array(frame["pix"])))


@pytest.mark.parametrize("name", kprobe.VARIANTS)
def test_kprobe_variant_matches_jax(frame, name):
    mod, _ = _load("kprobe")
    want = np.asarray(mod.run_variant(name, frame["gathered"],
                                      frame["counts"], frame["pix"], 8)())
    packed, cand, counts, pix = _port_inputs(frame)
    got = kprobe.ablate(name, packed, cand, counts, pix, 8).numpy()
    assert got.shape == want.shape == (cand.shape[0], 4, 256)
    if name in ("prod", "prod_static"):
        rad, trans, _ = peel_fused_torch(packed, cand, pix, 8)
        np.testing.assert_array_equal(got[:, :3], rad.numpy())
        np.testing.assert_array_equal(got[:, 3], trans.numpy())
        assert got[:, :3].max() > 0.1
        assert_images_close(got, want)
        return
    if name == "empty":
        np.testing.assert_array_equal(got, want)
        return
    fin = np.isfinite(want[:, 0])
    assert 0.2 < fin.mean() < 1.0
    both = np.isfinite(got[:, 0]) & fin
    assert (np.isfinite(got[:, 0]) == fin).mean() >= 0.998
    np.testing.assert_allclose(got[:, 0][both], want[:, 0][both], rtol=1e-4)
    if name == "merge_t1":
        for ch in (1, 2, 3):
            np.testing.assert_allclose(got[:, ch][both], want[:, ch][both],
                                       rtol=1e-4)
            np.testing.assert_array_equal(got[:, ch][~both & ~fin],
                                          want[:, ch][~both & ~fin])
        assert (got[-1, 1] == -np.inf).all()     # the empty tile
    else:
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
        assert (got[:, 1] == -np.inf).all() and (got[:, 2:] == 0).all()


@pytest.mark.parametrize("name", kprobe.SHADE_VARIANTS)
def test_kprobe_shading_matches_jax(frame, name):
    """In the script the shade variants min-reduce into a state at −inf, so
    its output cannot show their shading. With +inf for the initial state
    and for a missed candidate the port's channel 1 is the minimum of the
    shading terms over the candidates that hit; the same minimum is taken
    here from the script's own building blocks (_intersect_t1, _shade_q)
    on the gathered block, padding slots left out. The hit test is f32
    there and float64 here (99.8% of the pixels must agree on it). The dot
    products are sums in another order: atol 1e-6. The log-domain response
    B²/4A − (c0+3) cancels at c0+3 ≈ 10³, whose f32 ulp is 6e-5 to 1.2e-4,
    and A and B are summed in another order: atol 1e-3."""
    mod, _ = _load("kprobe")
    live = (frame["cand"] >= 0)[:, None, :]
    t1, a, b, cq, delta = mod._intersect_t1(frame["gathered"], frame["pix"])
    qa, r, g, bl = mod._shade_q(frame["gathered"], frame["pix"], t1, a, b,
                                cq, delta)
    if name == "shade_dots":
        col = frame["gathered"][..., 11:14]
        term = jnp.minimum(jnp.minimum(r - col[:, None, :, 0],
                                       g - col[:, None, :, 1]),
                           bl - col[:, None, :, 2])
    else:
        term = qa + r + g + bl if name == "shade_nomerge" else qa
        term = jnp.where(jnp.isfinite(qa), term, jnp.inf)
    want = np.asarray(jnp.where(live, term, jnp.inf).min(axis=-1))
    packed, cand, counts, pix = _port_inputs(frame)
    got = kprobe.ablate(name, packed, cand, counts, pix, 8, math.inf,
                        math.inf).numpy()
    np.testing.assert_array_equal(
        got[:, 0], kprobe.ablate("intersect", packed, cand, counts, pix,
                                 8).numpy()[:, 0])
    assert (got[:, 2:] == 0).all() and (got[-1, 1] == np.inf).all()
    fin = np.isfinite(want)
    assert 0.2 < fin.mean() <= 1.0
    assert (np.isfinite(got[:, 1]) == fin).mean() >= 0.998
    both = np.isfinite(got[:, 1]) & fin
    np.testing.assert_allclose(got[:, 1][both], want[both], rtol=0,
                               atol=1e-6 if name == "shade_dots" else 1e-3)


@pytest.mark.parametrize("name", lpprobe.FLOOR_VARIANTS)
def test_lpprobe_floor_matches_its_statement(frame, name):
    """The floor kernels of scripts/lpprobe.py are closures of its main();
    their functions, stated in numpy on the gathered block they read:
    nothing → +inf; touch → the tile's sum over the candidate axis of
    feature lane 0, broadcast to (T, 2K, P)."""
    packed, cand, _, pix = _port_inputs(frame)
    got = lpprobe.floor(name, packed, cand, pix.shape[1], 8).numpy()
    t = cand.shape[0]
    if name == "nothing":
        want = np.full((t, 16, 256), np.inf, np.float32)
        np.testing.assert_array_equal(got, want)
    else:
        s = np.asarray(frame["gathered"])[:, :, 0].sum(axis=1)
        want = np.broadcast_to(s[:, None, None], (t, 16, 256))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpprobe_keys_forms_agree(frame):
    packed, cand, _, pix = _port_inputs(frame)
    lb = torch.zeros((cand.shape[0], cand.shape[1] // 128 + 1))
    outs = {tag: fn() for tag, fn in
            lpprobe.keys_forms(packed, cand, lb, pix, 8).items()}
    assert len(outs) == 4 and all(lpprobe.forms_agree(outs).values())
    assert outs["pk lb=on"][0].shape == (cand.shape[0], 256, 8)


@pytest.mark.parametrize("probe", ["kmicro", "kprobe", "lpprobe"])
def test_probe_cli_runs_on_the_cpu_without_jax(probe, tmp_path):
    """Each probe as a program, with importing jax, rtgs_tpu or scripts
    made to fail; and without --device cpu it raises here (no CUDA)."""
    import os
    import subprocess

    args = {"kmicro": ["--t", "1", "--iters", "1"],
            "kprobe": ["600", "32", "32", "--cand", "128", "--iters", "1",
                       "--variants", ",".join(kprobe.VARIANTS)],
            "lpprobe": ["600", "32", "32", "--cand", "128", "--iters", "1"]}
    code = (
        "import sys\n"
        "for name in ('jax', 'rtgs_tpu', 'scripts'):\n"
        "    sys.modules[name] = None\n"
        f"from rtgs_tpu_torch.probes.{probe} import main\n"
        f"main({args[probe] + ['--device', 'cpu']!r})\n"
        "import torch\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        f"        main({args[probe]!r})\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA is not available' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('ran without a card')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("ms") >= 6
