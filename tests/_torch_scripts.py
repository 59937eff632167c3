"""The JAX package's scripts (``scripts/*.py``), loaded by path and left as
they are, for the tests that hold the port's probes against them. Imported
by its bare name: pytest puts this directory on ``sys.path``."""

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import jax.numpy as jnp

import rtgs_tpu.scene as jscene
import rtgs_tpu.utils.platform as jplatform
from rtgs_tpu import gaussians as JG
from rtgs_tpu.train import solver as jsolver

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_script(name):
    """``scripts/<name>.py`` as a module of its own."""
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_scene(fields):
    """The numpy scene ``fields`` as the JAX package's Gaussians."""
    return JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})


def run_script(name, argv, fields, mp):
    """Run ``scripts/<name>.py``'s main() on the scene ``fields`` (in place
    of its ``random_scene``) with ``argv``, under the MonkeyPatch ``mp``;
    returns its last JSON line and, per step, the JAX solver's (PSNR, live
    count)."""
    mod = load_script(name)
    scene = jax_scene(fields)
    mp.setattr(jscene, "random_scene", lambda key, n, **kw: scene)
    mp.setattr(jplatform, "enable_compilation_cache", lambda *a, **k: None)
    steps = []
    train_step = jsolver.Solver.train_step

    def recorded(self):
        m = train_step(self)
        steps.append((m["psnr"], self.num_live))
        return m

    mp.setattr(jsolver.Solver, "train_step", recorded)
    mp.setattr(sys, "argv", [name] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return json.loads(out.getvalue().strip().splitlines()[-1]), steps
