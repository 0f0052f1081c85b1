"""Config serialization, CSV-loader fuzzing, distributed-init no-op."""

import io

import numpy as np
import pytest

from mcport.config import Config, DataConfig, GBMConfig, SimulationConfig, period_info
from mcport.data import CsvFormatError, read_csv_file, try_read_csv_file
from mcport.parallel import maybe_initialize_distributed


def test_config_json_roundtrip():
    cfg = Config(
        data=DataConfig(period="W", strip_thousands=False),
        simulation=SimulationConfig(n_portfolios=123, seed=9, target_risk=0.25),
        gbm=GBMConfig(n_paths=2048, antithetic=True, qmc="sobol"),
    )
    restored = Config.from_json(cfg.to_json())
    assert restored == cfg
    assert restored.data.resample_rule == "W" and restored.data.annual_factor == 52


def test_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown config key"):
        Config.from_dict({"simulation": {"n_portfolios": 10, "bogus": 1}})


def test_period_info_aliases():
    assert period_info("M") == ("ME", 12)
    assert period_info("me") == ("ME", 12)
    assert period_info("Q") == ("QE", 4)
    assert period_info("D") == ("D", 252)
    with pytest.raises(ValueError):
        period_info("fortnightly")


def test_reference_defaults():
    """Defaults must equal the reference's constants (SURVEY.md §5 config table)."""
    cfg = Config()
    assert cfg.simulation.n_portfolios == 2500        # app.py:681
    assert cfg.simulation.max_retries == 100          # app.py:701
    assert cfg.simulation.alpha == 0.95               # app.py:685
    assert cfg.portfolio.investment_amount == 10_000  # app.py:374
    assert cfg.forecast.horizons == (1, 3, 6)         # app.py:789
    assert cfg.payoff.n_points == 100                 # app.py:593
    assert (cfg.payoff.lo_mult, cfg.payoff.hi_mult) == (0.5, 1.5)
    assert cfg.simulation.target_risk == 0.30         # README.md:4 north star


def test_csv_loader_fuzz(rng):
    """Random garbage never escapes as anything but CsvFormatError/None."""
    alphabet = list("abcDEF0123456789,;\"'\n\r\t .-/")
    for i in range(60):
        n = int(rng.integers(1, 400))
        junk = "".join(rng.choice(alphabet, n))
        s, err = try_read_csv_file(io.BytesIO(junk.encode()))
        assert (s is None) == (err is not None)
        if s is not None:
            assert len(s.dates) == len(s.prices) > 0


def test_csv_loader_adversarial_cases():
    cases = [
        b"",                                 # empty file
        b"Date,Price\n",                     # header only
        b"Date,Price\n,,\n",                 # empty row
        b"date , price\n2024-01-01,1\n",     # spaces around names
        b"\xef\xbb\xbfDate,Price\n2024-01-01,2\n",  # BOM
        b"Date,Price\nnot-a-date,xyz\n",     # all-coerce-fail
    ]
    for raw in cases:
        df, err = try_read_csv_file(io.BytesIO(raw))
        assert (df is None) == (err is not None)


def test_distributed_init_noop_single_process():
    assert maybe_initialize_distributed() is False


def test_matmul_precision_forced_f32():
    """mcport forces float32 matmul precision process-wide: on the GPU, XLA's
    default runs float32 matmuls as TF32 (10-bit mantissa, ~1e-3 relative),
    which would silently break the framework's 1e-6 parity contract. MCPORT_MATMUL_PRECISION
    overrides (mcport/__init__.py)."""
    import jax

    import mcport  # noqa: F401

    assert str(jax.config.jax_default_matmul_precision) == "float32"
