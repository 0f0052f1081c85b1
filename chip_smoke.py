"""Smoke test of mcport on a GPU: the main path at full size, every fused
kernel as Triton compiled it against its plain reference, and each kernel's
time against the XLA (lax) form it replaces.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # only the paths-sharded engine on 4 GPUs

One process does everything: a JAX process reserves most of the card's
memory, so a second one could not run beside it. The GPU-marked tests run
in this process through ``pytest.main``.

Phases (one GPU):
1. the CLI's main path at full size, with the kernels: ``gbm-risk`` (16,777,216
   paths x 252 steps in 1,048,576-path blocks), ``path-risk`` (1,048,576 x 252)
   and ``dd-frontier`` (256 candidates x 131,072 paths x 252) on the bundled
   daily-dated fixtures (14 assets that inner-join);
2. ``tests/test_gpu_kernels.py``: each kernel against its plain-jnp twin on the
   same draws at real widths, and in law against the lax engine;
3. each CLI command timed with the kernels and with ``--no-pallas`` (warm,
   median and spread of 5 runs), and the families that run only their lax
   forms: DCC and bootstrap (terminal), CCC-GARCH and Merton-jump (terminal)
   and Heston (path risk).

Exits non-zero, printing no result line, when JAX finds no GPU or any phase
fails. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPEATS = 5
PATHS_GBM = 16_777_216
BLOCK = 1_048_576                # gbm-risk's engine block (mcport.cli)
PATHS_PATH_RISK = 1_048_576
DD_CANDIDATES, DD_PATHS = 256, 131_072
PATHS_DCC, PATHS_FAMILY = 131_072, 1_048_576   # the lax-only model families
STEPS = 252


def _gpu_devices():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found {devices[0].platform!r}")
    return devices


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _universe() -> list[str]:
    """The bundled daily-dated fixtures: the largest set that inner-joins."""
    paths = [str(p) for p in sorted((ROOT / "fixtures").glob("*.csv"))
             if "Weekly" not in p.name]
    if len(paths) < 2:
        raise SystemExit("chip_smoke: the fixtures/ directory is missing")
    return paths


def _cli(argv: list[str]) -> dict:
    """``python -m mcport.cli argv`` in this process; its JSON output."""
    from mcport import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


def _timed(fn) -> dict:
    """Warm ``fn`` once (compilation), then time REPEATS calls. ``fn`` ends in
    host values (the CLI's JSON) or blocks on its device result itself."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return {"first_s": first, "median_s": statistics.median(times),
            "min_s": min(times), "max_s": max(times)}


def _commands(csvs: list[str]) -> dict[str, list[str]]:
    common = [*csvs, "--period", "D", "--steps", str(STEPS), "--seed", "0"]
    return {
        "gbm-risk": ["gbm-risk", *common, "--paths", str(PATHS_GBM)],
        "path-risk": ["path-risk", *common, "--models", "gbm",
                      "--paths", str(PATHS_PATH_RISK)],
        "dd-frontier": ["dd-frontier", *common, "--candidates",
                        str(DD_CANDIDATES), "--paths", str(DD_PATHS)],
    }


def phase_main_path(csvs: list[str]) -> None:
    import math

    cmds = _commands(csvs)
    out = _cli(cmds["gbm-risk"])
    assert out["n_paths"] == PATHS_GBM and out["done"], out
    assert len(out["weights"]) == len(csvs)
    assert math.isfinite(out["var"]) and math.isfinite(out["cvar"])
    assert -1.0 < out["cvar"] <= out["var"], out
    print(f"gbm-risk {PATHS_GBM} x {STEPS}: var {out['var']:.6f} "
          f"cvar {out['cvar']:.6f} mean {out['portfolio_mean_return']:.6f}",
          flush=True)

    out = _cli(cmds["path-risk"])["gbm"]
    assert out["n_paths"] == PATHS_PATH_RISK, out
    assert out["cvar"] <= out["var"], out
    assert -1.0 <= out["dd_p95"] <= out["dd_median"] <= 0.0, out
    print(f"path-risk {PATHS_PATH_RISK} x {STEPS}: var {out['var']:.6f} "
          f"cvar {out['cvar']:.6f} dd_median {out['dd_median']:.6f} "
          f"dd_p95 {out['dd_p95']:.6f}", flush=True)

    out = _cli(cmds["dd-frontier"])
    assert out["n_candidates"] == DD_CANDIDATES and "error" not in out, out
    assert out["dd_p95"] >= -out["dd_budget"] - 1e-9, out
    assert abs(sum(out["weights"].values()) - 1.0) < 1e-5, out
    print(f"dd-frontier {DD_CANDIDATES} x {DD_PATHS} x {STEPS}: "
          f"feasible {out['n_feasible']} return {out['expected_return']:.6f} "
          f"dd_p95 {out['dd_p95']:.6f}", flush=True)


def phase_gpu_tests() -> None:
    import pytest

    os.environ["MCPORT_GPU"] = "1"
    rc = pytest.main([str(ROOT / "tests" / "test_gpu_kernels.py"), "-m", "gpu",
                      "-q", "-o", "addopts=", "-p", "no:cacheprovider",
                      "-rs"])
    if rc != 0:
        raise SystemExit(f"chip_smoke: GPU tests failed (pytest exit {rc})")


def phase_timings(csvs: list[str]) -> None:
    for name, argv in _commands(csvs).items():
        kern = _timed(lambda: _cli(argv))
        lax = _timed(lambda: _cli([*argv, "--no-pallas"]))
        print(f"timing {name} kernel {json.dumps(kern)}", flush=True)
        print(f"timing {name} xla {json.dumps(lax)}", flush=True)
        print(f"timing {name} xla/kernel median "
              f"{lax['median_s'] / kern['median_s']:.3f}", flush=True)
    common = [*csvs, "--period", "D", "--steps", str(STEPS), "--seed", "0"]
    family = ["--paths", str(PATHS_FAMILY)]
    for name, argv in (
            (f"dcc (lax) {PATHS_DCC}", ["garch-risk", *common, "--correlation",
                                        "dcc", "--paths", str(PATHS_DCC)]),
            (f"bootstrap (lax) {PATHS_FAMILY}", ["bootstrap-risk", *common,
                                                 *family]),
            (f"garch (lax) {PATHS_FAMILY}", ["garch-risk", *common, *family]),
            (f"jump (lax) {PATHS_FAMILY}", ["jump-risk", *common, *family]),
            (f"heston path-risk (lax) {PATHS_FAMILY}",
             ["path-risk", *common, "--models", "heston", *family])):
        print(f"timing {name} {json.dumps(_timed(lambda: _cli(argv)))}",
              flush=True)


def phase_four(csvs: list[str]) -> None:
    """run_sharded_resumable_mc over a 4-GPU paths mesh against the one-GPU
    run_resumable_mc on the same seed and block grid, then the multi-device
    dry run of every sharded engine."""
    import jax
    import numpy as np

    import __graft_entry__
    from mcport.config import DataConfig, GBMConfig
    from mcport.data import load_universe
    from mcport.engine.mc_engine import run_resumable_mc
    from mcport.models import estimate_gbm
    from mcport.parallel import make_mesh
    from mcport.parallel.sharded_resumable import run_sharded_resumable_mc

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}")
    mesh = make_mesh(devices[:4])
    d = load_universe(paths=csvs, config=DataConfig(period="D"))
    params = estimate_gbm(d.prices)
    w = np.full(d.n_assets, 1.0 / d.n_assets)
    cfg = GBMConfig(n_paths=PATHS_GBM, path_block=BLOCK, n_steps=STEPS, seed=0)

    one, _ = run_resumable_mc(params, w, cfg)
    four, ck = run_sharded_resumable_mc(params, w, mesh, cfg)
    assert ck.done and four.n_paths == one.n_paths == PATHS_GBM
    # integer histogram counts: the tail metrics are exact; the moments merge
    # per-device compensated sums in another order
    assert four.var == one.var and four.cvar == one.cvar, (four, one)
    np.testing.assert_allclose(four.mean, one.mean, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(four.cov, one.cov, rtol=1e-4, atol=1e-12)
    print(f"sharded 4 x GPU {PATHS_GBM} x {STEPS}: var {four.var:.6f} "
          f"cvar {four.cvar:.6f} (one GPU: {one.var:.6f} {one.cvar:.6f})",
          flush=True)
    t_one = _timed(lambda: run_resumable_mc(params, w, cfg))
    t_four = _timed(lambda: run_sharded_resumable_mc(params, w, mesh, cfg))
    print(f"timing run_resumable_mc 1 GPU {json.dumps(t_one)}", flush=True)
    print(f"timing run_sharded_resumable_mc 4 GPU {json.dumps(t_four)}",
          flush=True)
    __graft_entry__.dryrun_multichip(4)
    print("dryrun_multichip(4) ok", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU paths-sharded engine and its "
                         "one-GPU comparison")
    args = ap.parse_args(argv)

    devices = _gpu_devices()
    sys.path.insert(0, str(ROOT))
    csvs = _universe()
    print(_card(), flush=True)
    print(f"devices: {len(devices)} x {devices[0].device_kind}", flush=True)
    if args.four:
        phase_four(csvs)
    else:
        phase_main_path(csvs)
        phase_gpu_tests()
        phase_timings(csvs)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
