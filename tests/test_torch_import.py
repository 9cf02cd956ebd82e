"""The PyTorch port imports no jax, and its re-declared constants equal the
JAX package's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port (the command line, its I/O modules and
    the bench suite too), and chip_smoke, imported in a fresh process, and
    ``bench_torch.py --help`` run in it: neither jax, nor any module of
    the JAX package, nor its bench is loaded."""
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import cutesdr_tpu_torch\n"
        "for m in pkgutil.walk_packages(cutesdr_tpu_torch.__path__,\n"
        "                               'cutesdr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "sys.argv = ['bench_torch.py', '--help']\n"
        "try:\n"
        "    runpy.run_path('bench_torch.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    cutesdr_tpu_torch.__path__, 'cutesdr_tpu_torch.')]\n"
        "for want in ('session', 'bank', 'serve', 'shard.coherent',\n"
        "             'testbench.probes', 'design.latency', 'cli',\n"
        "             'testbench.generators', 'io.ascp', 'io.ad6620',\n"
        "             'io.netsdr', 'io.filesource', 'io.recorder',\n"
        "             'io.native_ingest', 'io.discover', 'io.audio_device',\n"
        "             'shard.mesh', 'shard.timeshard', 'shard.pipeline',\n"
        "             'shard.multihost', 'bench_suite'):\n"
        "    assert 'cutesdr_tpu_torch.' + want in names, names\n"
        "assert len(names) >= 64, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cutesdr_tpu' or m.startswith('cutesdr_tpu.')\n"
        "       or m == 'bench']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--frames-per-block" in proc.stdout     # the help was printed


def test_bench_entry_points_default_to_the_card(monkeypatch, capsys):
    """The flagship, the suite, each kind of row and the CLI's bench name
    the card: with no CUDA device and no device given they raise (the
    flagship's line reports the error and exits 1), never running on the
    CPU."""
    from cutesdr_tpu_torch import bench_suite as bs
    from cutesdr_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = bs.rows()
    for make in (bs.bench_receiver, bs.run_suite,
                 lambda: bs.bench_receiver_cfg("x", table[2].cfg,
                                               np.zeros(4)),
                 lambda: bs.bench_channel_bank(table[4].cfg),
                 lambda: bs.bench_latency_mode(table[9]),
                 lambda: bs.session_breakdown(table[6].cfg),
                 lambda: bs.bench_session_streaming(table[7].cfg, 8, 2),
                 lambda: bs.chain_step(table[2].cfg, np.zeros(4), "cuda"),
                 lambda: cli.main(["bench"]),
                 lambda: cli.main(["bench", "--suite"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    capsys.readouterr()
    assert bs.flagship_main([]) == 1
    line = json.loads(capsys.readouterr().out)
    assert "no CUDA device" in line["error"] and "value" not in line


def test_shard_entry_points_default_to_the_card(monkeypatch):
    """make_mesh, PipelinedReceiver and global_time_mesh name the card:
    with no CUDA device and no device given they raise, never falling
    back to the CPU; given "cpu" they run there."""
    from cutesdr_tpu_torch.pipeline import receiver as trx
    from cutesdr_tpu_torch.shard import PipelinedReceiver, make_mesh
    from cutesdr_tpu_torch.shard import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trx.ReceiverConfig(input_rate=250_000.0)
    for make in (lambda: make_mesh(time=2),
                 lambda: PipelinedReceiver(cfg),
                 lambda: PipelinedReceiver(cfg, device_front="cpu"),
                 lambda: multihost.global_time_mesh(),
                 lambda: multihost.initialize("127.0.0.1:1", 1, 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    mesh = make_mesh(time=2, devices=["cpu", "cpu"])
    assert [d.type for d in mesh.axis_devices("t")] == ["cpu", "cpu"]
    assert PipelinedReceiver(cfg, "cpu", "cpu").device_back.type == "cpu"


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
    from cutesdr_tpu import demod as j_demod
    from cutesdr_tpu import types as j_types
    from cutesdr_tpu.io import audio_sink as j_sink
    from cutesdr_tpu.ops import noiseblanker as j_nb
    from cutesdr_tpu.pipeline import spectrum as j_sp
    from cutesdr_tpu_torch import demod as t_demod
    from cutesdr_tpu_torch import types as t_types
    from cutesdr_tpu_torch.io import audio_sink as t_sink
    from cutesdr_tpu_torch.ops import noiseblanker as t_nb
    from cutesdr_tpu_torch.pipeline import spectrum as t_sp

    for name in ("K_PI", "K_2PI", "MAX_AMPLITUDE"):
        assert getattr(t_types, name) == getattr(j_types, name), name
    assert t_demod.MODE_IDS == j_demod.MODE_IDS
    assert t_demod.MODE_NAMES == j_demod.MODE_NAMES
    for name in t_demod.MODE_IDS:
        tag = "DEMOD_" + name.upper()
        assert getattr(t_demod, tag) == getattr(j_demod, tag)
    assert (t_nb.MAX_WIDTH, t_nb.MAGAVE_TIME) == (j_nb.MAX_WIDTH,
                                                  j_nb.MAGAVE_TIME)
    for name in ("MIN_FFT_SIZE", "MAX_FFT_SIZE", "K_MAXDB", "K_MINDB",
                 "OVER_LIMIT"):
        assert getattr(t_sp, name) == getattr(j_sp, name), name
    for name in ("OUTQSIZE", "FILTERQLEVEL_ALPHA", "P_GAIN", "PPM_ALARM"):
        assert getattr(t_sink, name) == getattr(j_sink, name), name
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
    assert names == ["agcseq.cu", "blanker.cu", "common.cuh", "fastfir.cu",
                     "iir.cu", "mixdec.cu", "resamp.cu", "scan.cu",
                     "scan_common.cuh", "seqloop.cu", "smeter.cu"]
    assert str(_build.BUILD_ROOT.parent) == os.path.join(ROOT, "build")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_design_copies_match_reference():
    """The port's own copies of the JAX package's numpy design functions
    give bitwise the same results for a few parameter sets each."""
    import dataclasses

    import numpy as np

    from cutesdr_tpu.design import decimation_plan as j_dp
    from cutesdr_tpu.design import fastfir_design as j_ffd
    from cutesdr_tpu.design import fir_kaiser as j_fk
    from cutesdr_tpu.design import iir_biquad as j_iir
    from cutesdr_tpu.design import windows as j_win
    from cutesdr_tpu_torch.design import decimation_plan as t_dp
    from cutesdr_tpu_torch.design import fastfir_design as t_ffd
    from cutesdr_tpu_torch.design import fir_kaiser as t_fk
    from cutesdr_tpu_torch.design import iir_biquad as t_iir
    from cutesdr_tpu_torch.design import windows as t_win

    eq = np.testing.assert_array_equal
    for rate, bw in ((2e6, 20_000.0), (250e3, 10_000.0), (20e6, 1000.0),
                     (10e6, 15_000.0), (62_500.0, 20_000.0)):
        tp, jp = t_dp.plan_decimation(rate, bw), j_dp.plan_decimation(rate, bw)
        assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
        eq(tp.composed_taps(), jp.composed_taps())
        for name in tp.stages:
            eq(tp.stage_taps(name), jp.stage_taps(name))
    for args, kw in (((100.0, 2800.0, 0.0, 62_500.0), {}),
                     ((-250.0, 250.0, 600.0, 15_625.0), {}),
                     ((-5000.0, 5000.0, 0.0, 31_250.0),
                      dict(fft_size=4096, fir_size=3073))):
        eq(t_ffd.design_fastfir(*args, **kw), j_ffd.design_fastfir(*args, **kw))
    assert (t_ffd.CONV_FFT_SIZE, t_ffd.CONV_FIR_SIZE) == (
        j_ffd.CONV_FFT_SIZE, j_ffd.CONV_FIR_SIZE)
    for args in ((1.0, 50.0, 5000.0, 9000.0, 31_250.0),
                 (1.0, 40.0, 4500.0, 5500.0, 62_500.0)):
        eq(t_fk.design_lowpass(*args), j_fk.design_lowpass(*args))
    eq(t_fk.design_highpass(1.0, 50.0, 7500.0, 4500.0, 62_500.0),
       j_fk.design_highpass(1.0, 50.0, 7500.0, 4500.0, 62_500.0))
    lp = j_fk.design_lowpass(1.0, 40.0, 4500.0, 5500.0, 31_250.0)
    for a, b in zip(t_fk.hilbert_bandpass(lp, 5000.0, 31_250.0),
                    j_fk.hilbert_bandpass(lp, 5000.0, 31_250.0)):
        eq(a, b)
    for args in ((3000.0, 1.0, 62_500.0), (3000.0, 0.707, 15_625.0)):
        assert t_iir.biquad_lowpass(*args) == j_iir.biquad_lowpass(*args)
    for name in ("hann", "blackman_harris", "blackman_nuttall", "flattop"):
        for n, gain in ((4096, True), (1025, False)):
            eq(t_win.window_table(name, n, with_gain=gain),
               j_win.window_table(name, n, with_gain=gain))


def test_numpy_copies_match_reference():
    """serve.py (the page and every class), testbench/probes.py's
    TriggerMode and TriggeredCapture and the native ingest's class are
    the JAX package's numpy code, line for line; the re-declared constants
    of the serving surface are the JAX package's."""
    import inspect

    from cutesdr_tpu import bank as j_bank
    from cutesdr_tpu import serve as j_serve
    from cutesdr_tpu import session as j_session
    from cutesdr_tpu.design import latency as j_lat
    from cutesdr_tpu.ops import resampler as j_rs
    from cutesdr_tpu.testbench import probes as j_probes
    from cutesdr_tpu_torch import bank as t_bank
    from cutesdr_tpu_torch import serve as t_serve
    from cutesdr_tpu_torch import session as t_session
    from cutesdr_tpu_torch.design import latency as t_lat
    from cutesdr_tpu_torch.ops import resampler as t_rs
    from cutesdr_tpu_torch.testbench import probes as t_probes

    body = lambda m: inspect.getsource(m).split("\n_PAGE = ", 1)[1]
    assert body(t_serve) == body(j_serve)
    for name in ("TriggerMode", "_TrigState", "TriggeredCapture"):
        assert (inspect.getsource(getattr(t_probes, name))
                == inspect.getsource(getattr(j_probes, name))), name
    assert t_bank.SPECTRA_BINS == j_bank.SPECTRA_BINS
    assert t_session.PROBE_TAPS == j_session.ReceiverSession.PROBE_TAPS
    assert t_rs.MAX_SOUNDCARDVAL == j_rs.MAX_SOUNDCARDVAL
    assert (t_lat.MIN_NFFT, t_lat.MAX_NFFT) == (j_lat.MIN_NFFT,
                                                j_lat.MAX_NFFT)
    # the native ingest's class (its build is the port's own)
    from cutesdr_tpu.io import native_ingest as j_ing
    from cutesdr_tpu_torch.io import native_ingest as t_ing
    assert (inspect.getsource(t_ing.NativeIngest)
            == inspect.getsource(j_ing.NativeIngest))


IO_COPIES = ("io/ascp", "io/ad6620", "io/netsdr", "io/filesource",
             "io/recorder", "io/discover", "io/audio_device",
             "testbench/generators")


def _code(path: str) -> str:
    """A module's source after its docstring, with the port's package
    name read as the JAX package's."""
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    body = src[src.index('"""', 3) + 3:]
    return body.replace("cutesdr_tpu_torch", "cutesdr_tpu")


@pytest.mark.parametrize("name", IO_COPIES)
def test_io_copies_match_reference(name):
    """The command line's numpy I/O modules and the signal generator are
    the JAX package's code line for line; only their imports name the
    port."""
    assert _code(f"cutesdr_tpu_torch/{name}.py") == _code(
        f"cutesdr_tpu/{name}.py")
