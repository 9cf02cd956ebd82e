"""The PyTorch port imports no jax, and its re-declared constants equal the
JAX package's."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "import cutesdr_tpu_torch, cutesdr_tpu_torch.convert\n"
        "import cutesdr_tpu_torch.pipeline.receiver\n"
        "import cutesdr_tpu_torch.kernels.mixdec\n"
        "import cutesdr_tpu_torch.kernels.fastfir\n"
        "import cutesdr_tpu_torch.kernels.scan\n"
        "import cutesdr_tpu_torch.kernels.seqloop\n"
        "import cutesdr_tpu_torch.demod.am, cutesdr_tpu_torch.demod.fm\n"
        "import cutesdr_tpu_torch.demod.sam, cutesdr_tpu_torch.ops.iir\n"
        "import cutesdr_tpu_torch.ops.resampler\n"
        "import cutesdr_tpu_torch.shard.channels\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('cutesdr_tpu.pipeline')\n"
        "       or m.startswith('cutesdr_tpu.ops')\n"
        "       or m.startswith('cutesdr_tpu.kernels')\n"
        "       or m.startswith('cutesdr_tpu.shard')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_redeclared_constants_match_reference():
    from cutesdr_tpu.kernels import scan1 as j_scan
    from cutesdr_tpu.ops import agc as j_agc
    from cutesdr_tpu.ops import fastfir as j_ff
    from cutesdr_tpu.ops import resampler as j_rs
    from cutesdr_tpu.ops import smeter as j_sm
    from cutesdr_tpu.pipeline import receiver as j_rx
    from cutesdr_tpu_torch.kernels import scan as t_scan
    from cutesdr_tpu_torch.ops import agc as t_agc
    from cutesdr_tpu_torch.ops import fastfir as t_ff
    from cutesdr_tpu_torch.ops import resampler as t_rs
    from cutesdr_tpu_torch.ops import smeter as t_sm
    from cutesdr_tpu_torch.pipeline import receiver as t_rx

    assert t_rx.MODE_LIMITS == j_rx.MODE_LIMITS
    assert t_rx.MODE_DEFAULT_CUTS == j_rx.MODE_DEFAULT_CUTS
    assert t_rx.SOUNDCARD_RATE == j_rx.SOUNDCARD_RATE
    for name in ("DELAY_TIMECONST", "WINDOW_TIMECONST",
                 "ATTACK_RISE_TIMECONST", "ATTACK_FALL_TIMECONST",
                 "DECAY_RISEFALL_RATIO", "RELEASE_TIMECONST", "AGC_OUTSCALE",
                 "MIN_CONSTANT", "MAX_DELAY_SAMPLES", "GUESS_ITERS"):
        assert getattr(t_agc, name) == getattr(j_agc, name), name
    for name in ("ATTACK_TIMECONST", "DECAY_TIMECONST", "SMETER_CALIBRATION",
                 "MAX_PWR"):
        assert getattr(t_sm, name) == getattr(j_sm, name), name
    assert (t_ff.NFFT, t_ff.NFIR, t_ff.VALID) == (j_ff.NFFT, j_ff.NFIR,
                                                 j_ff.VALID)
    for name in ("SINC_PERIODS", "SINC_PERIOD_PTS", "_DT_SPLIT", "_K_SPLIT",
                 "_CHUNK", "_BH_COEFS"):
        assert getattr(t_rs, name) == getattr(j_rs, name), name
    from cutesdr_tpu.demod import am as j_am
    from cutesdr_tpu.demod import fm as j_fm
    from cutesdr_tpu.demod import sam as j_sam
    from cutesdr_tpu.ops import pll as j_pll
    from cutesdr_tpu_torch.demod import am as t_am
    from cutesdr_tpu_torch.demod import fm as t_fm
    from cutesdr_tpu_torch.demod import sam as t_sam
    from cutesdr_tpu_torch.ops import pll as t_pll

    assert t_am.DC_ALPHA == j_am.DC_ALPHA == j_sam.DC_ALPHA
    for name in ("PLL_BW", "PLL_ZETA", "PLL_LIMIT", "TIER_LINEAR",
                 "TIER_SCAN"):
        assert getattr(t_sam, name) == getattr(j_sam, name), name
    for name in ("FMPLL_RANGE", "VOICE_BANDWIDTH", "FMPLL_BW", "FMPLL_ZETA",
                 "FMDC_ALPHA", "MAX_FMOUT", "SQUELCH_MAX",
                 "SQUELCHAVE_TIMECONST", "SQUELCH_HYSTERESIS", "PLL_CHUNK",
                 "PLL_HALO", "TIER_LINEAR", "TIER_CHUNKED", "TIER_SCAN"):
        assert getattr(t_fm, name) == getattr(j_fm, name), name
    for n in (256, 384, 512, 1000, 1024, 262144):
        assert t_fm._chunkable(n) == j_fm._chunkable(n)
    assert t_pll.WRAP_MARGIN == j_pll.WRAP_MARGIN
    assert t_scan.MIN_KERNEL_N == j_scan.MIN_KERNEL_N
    assert t_scan.ROWS_PER_STEP == j_scan.ROWS_PER_STEP
    for n in (65536, 65536 + 128, 262144, 1024):
        assert t_scan.smeter_supported(n) == j_scan.smeter_supported(n)


def test_wrappers_reject_unsupported_devices():
    import pytest

    from cutesdr_tpu_torch.kernels import _build, scan

    meta = torch.empty(65536, device="meta")
    with pytest.raises(ValueError):
        scan.first_order_scan(meta, meta, 0.0)
    with pytest.raises(ValueError):
        _build.on_cpu(torch.empty(1), meta)
    assert _build.on_cpu(torch.empty(1), torch.empty(2))


def test_kernel_library_is_built_from_the_checkout():
    """The build reads csrc/ of this checkout only, keyed by its content,
    into a directory that .gitignore lists."""
    from cutesdr_tpu_torch.kernels import _build

    names = sorted(p.name for p in _build._sources())
    assert names == ["common.cuh", "fastfir.cu", "mixdec.cu", "scan.cu",
                     "scan_common.cuh", "seqloop.cu", "smeter.cu"]
    assert str(_build.BUILD_ROOT.parent) == os.path.join(ROOT, "build")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
