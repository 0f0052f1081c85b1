"""Collective-structure pinning for the sharded tier (VERDICT r4 weak #6).

The CPU-mesh value tests prove the sharded engines compute the right thing;
nothing guarded WHAT they communicate. A refactor could silently introduce an
extra all-gather (e.g. materializing the path axis) and every value test
would still pass. This suite lowers each sharded engine on the 8-device CPU
mesh and pins the compiled HLO's collective structure:

- the multiset of collective opcodes (all-reduce / all-gather / ...) per
  engine is EXACTLY the expected one — psum-only engines must stay psum-only;
- every all-gather result stays small (winner weights / frontier metrics),
  never path-axis-sized: total gathered elements per engine are bounded.

Counts are per compiled module with XLA's all-reduce combiner active, so N
same-shaped psums that fuse into one all-reduce count as XLA emits them —
the pinned numbers are the OBSERVED structure of the current design (interconnect
traffic per dispatch), and any drift (new gather, un-fused reduce, dropped
psum) fails loudly. Run ``python tests/test_collective_structure.py`` to
print a fresh census when intentionally changing an engine's comms.

SURVEY.md §5 (distributed backend): moments reduce with psum, tail metrics
via psum'd fixed-grid sketches, winners via small all-gathers.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

A = 3
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


_DEF = re.compile(r"=\s*(.+?)\s+(" + "|".join(_COLLECTIVES)
                  + r")(?:-start)?\(")
_SHAPE = re.compile(r"[a-z0-9]+\[([\d,]*)\]")


def _type_elems(typestr: str) -> int:
    """Total elements across every shape in an HLO result type (tuples too)."""
    total = 0
    for m in _SHAPE.finditer(typestr):
        dims = m.group(1)
        total += int(np.prod([int(d) for d in dims.split(",")])) if dims else 1
    return total


def _parse(txt: str, counts: dict, ag_elems: list) -> None:
    for line in txt.splitlines():
        m = _DEF.search(line)
        if m is None:
            continue
        op = m.group(2)
        counts[op] = counts.get(op, 0) + 1
        if op == "all-gather":
            ag_elems.append(_type_elems(m.group(1)))


def census(fn) -> dict:
    """Compile ``fn()`` and return {opcode: count} over instruction
    DEFINITIONS (XLA combines same-shaped psums into one tuple all-reduce;
    operand references and -done halves are not counted) + max/total
    all-gather result elements.

    Engines that post-process on host (float() on device outputs) cannot be
    traced whole; for those, every ``jax.jit`` the engine creates at call
    time is spied on and the captured inner modules are merged. Each DISTINCT
    program is counted once: a host-side chunk loop (w_block etc.) that
    dispatches the same compiled program N times pins the per-dispatch
    structure, not N-times-inflated counts, and compiles once, not N times
    (review r5)."""
    counts: dict = {}
    ag_elems: list = []
    try:
        _parse(jax.jit(fn).lower().compile().as_text(), counts, ag_elems)
    except (jax.errors.ConcretizationTypeError,
            jax.errors.TracerArrayConversionError,
            jax.errors.TracerBoolConversionError):
        real_jit = jax.jit
        seen_programs: set = set()

        def spy_jit(f, *a, **kw):
            jf = real_jit(f, *a, **kw)
            compiled_cache: dict = {}

            def wrapper(*args, **kwargs):
                # one compile per abstract signature, not one per dispatch:
                # the AOT result of lower().compile() is callable and cached,
                # so a chunked engine neither re-compiles per chunk (compile
                # pressure on the known single-process XLA:CPU
                # compile-accumulation crash) nor re-counts an identical
                # program's collectives per chunk
                leaves, tdef = jax.tree_util.tree_flatten((args, kwargs))
                key = (tdef, tuple(
                    jax.api_util.shaped_abstractify(x)
                    if isinstance(x, (jax.Array, np.ndarray)) else x
                    for x in leaves))
                compiled = compiled_cache.get(key)
                if compiled is None:
                    compiled = jf.lower(*args, **kwargs).compile()
                    compiled_cache[key] = compiled
                    txt = compiled.as_text()
                    if txt not in seen_programs:
                        seen_programs.add(txt)
                        _parse(txt, counts, ag_elems)
                return compiled(*args, **kwargs)

            return wrapper

        jax.jit = spy_jit
        try:
            fn()
        finally:
            jax.jit = real_jit
    return {"ops": counts, "ag_max_elems": max(ag_elems, default=0),
            "ag_total_elems": sum(ag_elems)}


def _params():
    from mcport.models.dcc import DCCGarchParams
    from mcport.models.garch_mc import CCCGarchParams
    from mcport.models.gbm import GBMParams
    from mcport.models.heston import HestonParams
    from mcport.models.jump import MertonParams

    corr = (0.6 * np.eye(A) + 0.4)
    gbm = GBMParams(s0=np.ones(A) * 100,
                    mean_step=np.array([0.002, 0.001, 0.0015]),
                    chol_step=np.linalg.cholesky(0.0009 * corr))
    gp = CCCGarchParams(
        mu=np.full(A, 5e-4), omega=np.full(A, 1e-5),
        alpha=np.full(A, 0.08), beta=np.full(A, 0.9),
        corr_chol=np.linalg.cholesky(corr),
        sigma2_0=np.full(A, 5e-4), eps2_0=np.full(A, 5e-4))
    mp = MertonParams(diffusion=gbm, jump_rate=0.05,
                      jump_mean=np.full(A, -0.04), jump_vol=np.full(A, 0.06))
    dp = DCCGarchParams(base=gp, a_dcc=0.08, b_dcc=0.85, q0=corr,
                        e0=np.zeros(A))
    hp = HestonParams(
        mu=np.full(A, 8e-4), kappa=np.full(A, 0.15), theta=np.full(A, 4e-4),
        xi=np.full(A, 3e-3), rho=np.full(A, -0.5), v0=np.full(A, 4e-4),
        corr_chol=np.linalg.cholesky(0.5 * np.eye(A) + 0.5),
        s0=np.ones(A) * 100)
    hist = (np.random.default_rng(45).standard_t(5, (64, A)) * 0.02
            + 0.002).astype(np.float32)
    return gbm, gp, mp, dp, hp, hist


def build_matrix(mesh, mesh2):
    """{engine name: zero-arg callable} over tiny shapes (1024 paths/cands).

    ``mesh`` is the 1-D paths mesh (candidate-sharded engines run with
    axis="paths" — axis NAME does not change the collective structure);
    ``mesh2`` the (paths=4, cand=2) mesh for the 2-D forms."""
    from mcport.config import SketchConfig
    from mcport.options import HedgeSpec, LegType, Legs
    from mcport.parallel import sharded_engines as se
    from mcport.parallel.sharded_mc import sharded_gbm_risk, sharded_weight_search

    gbm, gp, mp, dp, hp, hist = _params()
    mean = jnp.asarray(gbm.mean_step, jnp.float32)
    chol = jnp.asarray(gbm.chol_step, jnp.float32)
    w = jnp.asarray([0.5, 0.3, 0.2], jnp.float32)
    lo, hi = jnp.zeros(A, jnp.float32), jnp.ones(A, jnp.float32)
    sk = SketchConfig(n_bins=512)
    n, s, nc = 1024, 4, 128
    key = jax.random.key(0)
    hedge = HedgeSpec.build(
        {0: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, 95.0, 1.0, 1.0)])},
        ["a0", "a1", "a2"])

    m = {
        "gbm_risk": lambda: sharded_gbm_risk(
            3, mean, chol, w, n, s, mesh, sketch=sk),
        "weight_search": lambda: sharded_weight_search(
            key, jnp.asarray(hist[:32]), mean, jnp.asarray(
                np.cov(hist[:32], rowvar=False), jnp.float32),
            nc, mesh, lo, hi, objective="sharpe", axis="paths"),
        "path_risk": lambda: se.sharded_path_risk(
            3, mean, chol, w, n, s, mesh, sketch=sk),
        "simulated_frontier": lambda: se.sharded_simulated_frontier(
            key, mean, chol, lo, hi, nc, n, s, mesh, objective="cvar",
            axis="paths"),
        "simulated_frontier_2d": lambda: se.sharded_simulated_frontier_2d(
            key, mean, chol, lo, hi, 8, n // 2, s, mesh2, objective="cvar"),
        "drawdown_frontier": lambda: se.sharded_drawdown_frontier(
            key, mean, chol, lo, hi, nc, n, s, mesh, w_block=16,
            axis="paths"),
        "bootstrap_risk": lambda: se.sharded_bootstrap_risk(
            key, hist, w, n, s, mesh),
        "garch_risk": lambda: se.sharded_garch_risk(3, gp, w, n, s, mesh),
        "merton_risk": lambda: se.sharded_merton_risk(3, mp, w, n, s, mesh),
        "dcc_risk": lambda: se.sharded_dcc_risk(3, dp, w, n, s, mesh),
        "importance_tail": lambda: se.sharded_importance_tail(
            3, gbm, w, n, s, mesh, alpha=0.999),
        "cvar_attribution": lambda: se.sharded_cvar_attribution(
            3, mean, chol, w, n, s, mesh, sketch=sk),
        "hedged_gbm_risk": lambda: se.sharded_hedged_gbm_risk(
            3, gbm, w, hedge, n, s, mesh),
        "american_value": lambda: se.sharded_american_value(
            3, [100.0, 90.0], 0.02, [100.0, 95.0], mesh, n_paths=n, n_steps=s),
    }
    for model, params_ in (("garch", gp), ("dcc", dp), ("jump", mp),
                           ("heston", hp), ("bootstrap", hist)):
        m[f"family_path_risk[{model}]"] = (
            lambda model=model, params_=params_: se.sharded_family_path_risk(
                3, model, params_, w, n, s, mesh, sketch=sk))
        m[f"family_dd_frontier[{model}]"] = (
            lambda model=model, params_=params_:
            se.sharded_family_drawdown_frontier(
                key, model, params_, lo, hi, nc, n, s, mesh, w_block=16,
                axis="paths"))
    return m


# The pinned structure (8-device CPU mesh, XLA all-reduce combiner on).
# ag_max is the largest all-gather RESULT in elements — must stay
# winner-sized (weights + metrics), never path-axis-sized.
EXPECTED = {
    "gbm_risk": {"all-reduce": 1, "ag_max": 0},
    "weight_search": {"all-reduce": 1, "all-gather": 2, "ag_max": 24},
    "path_risk": {"all-reduce": 1, "ag_max": 0},
    # paths replicated per device, candidates seed-partitioned: the winner
    # resolution needs only the two small gathers, no reduce at all
    "simulated_frontier": {"all-gather": 2, "ag_max": 24},
    "simulated_frontier_2d": {"all-reduce": 1, "all-gather": 2, "ag_max": 6},
    "drawdown_frontier": {"all-reduce": 1, "all-gather": 3, "ag_max": 24},
    "bootstrap_risk": {"all-reduce": 1, "ag_max": 0},
    "garch_risk": {"all-reduce": 1, "ag_max": 0},
    # jump fraction reduces separately from the moment/sketch tuple
    "merton_risk": {"all-reduce": 2, "ag_max": 0},
    "dcc_risk": {"all-reduce": 1, "ag_max": 0},
    # exact global normalizer + LR-weighted masses are two reduction rounds
    "importance_tail": {"all-reduce": 2, "ag_max": 0},
    # sketch threshold psum, then masked per-asset tail sums at the threshold
    "cvar_attribution": {"all-reduce": 2, "ag_max": 0},
    "hedged_gbm_risk": {"all-reduce": 1, "ag_max": 0},
    # distributed LSMC: normal-equation psums (gram+bty+itm-count fuse),
    # pmin/pmax of the ITM support, value-moment psums — K-sized, no gathers
    "american_value": {"all-reduce": 4, "ag_max": 0},
    "family_path_risk[garch]": {"all-reduce": 1, "ag_max": 0},
    "family_path_risk[dcc]": {"all-reduce": 1, "ag_max": 0},
    "family_path_risk[jump]": {"all-reduce": 1, "ag_max": 0},
    "family_path_risk[heston]": {"all-reduce": 1, "ag_max": 0},
    "family_path_risk[bootstrap]": {"all-reduce": 1, "ag_max": 0},
    "family_dd_frontier[garch]": {"all-reduce": 1, "all-gather": 3,
                                  "ag_max": 24},
    "family_dd_frontier[dcc]": {"all-reduce": 1, "all-gather": 3,
                                "ag_max": 24},
    "family_dd_frontier[jump]": {"all-reduce": 1, "all-gather": 3,
                                 "ag_max": 24},
    "family_dd_frontier[heston]": {"all-reduce": 1, "all-gather": 3,
                                   "ag_max": 24},
    "family_dd_frontier[bootstrap]": {"all-reduce": 1, "all-gather": 3,
                                      "ag_max": 24},
}

# paths per engine above — an all-gather result must never approach this
_N_PATHS = 1024


@pytest.fixture(scope="module")
def matrix(eight_devices):
    from mcport.parallel import make_mesh
    from mcport.parallel.mesh import make_mesh_2d

    return build_matrix(make_mesh(eight_devices),
                        make_mesh_2d(4, eight_devices))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_compiled_collective_structure(name, matrix):
    got = census(matrix[name])
    want = dict(EXPECTED[name])
    ag_max = want.pop("ag_max")
    assert got["ops"] == want, (
        f"{name}: compiled collectives {got['ops']} != pinned {want} — "
        "a comms regression (or an intentional change: re-census and re-pin)")
    assert got["ag_max_elems"] == ag_max, (
        f"{name}: largest all-gather grew to {got['ag_max_elems']} elements "
        f"(pinned {ag_max})")
    # belt-and-braces: nothing ever gathers anything path-axis-sized
    assert got["ag_total_elems"] < _N_PATHS // 2


if __name__ == "__main__":  # census mode: print actuals for re-pinning
    import os

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")
    from mcport.parallel import make_mesh
    from mcport.parallel.mesh import make_mesh_2d

    for nm, fn in build_matrix(make_mesh(jax.devices()),
                               make_mesh_2d(4, jax.devices())).items():
        print(nm, census(fn))
