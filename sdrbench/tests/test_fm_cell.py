"""The NBFM listener's cell, ``fm_nb_impulse``, from its own files: its
configuration, traffic and limits load through the harness; the cell at
a small size on the CPU reads ``correct`` against the reference, and not
with the blanker switched off; its four per-layer readers give None where
their kernel or counter is missing and the hand-computed value on a
synthetic trace."""

import copy
import json

import pytest

from sdrbench import correct, run, spec, trace, work
from sdrbench.tests import small

REPO = small.ROOT.parent
CELL = "fm_nb_impulse"


def _small():
    """The cell's own configuration and traffic files at the small size
    of ``small.listener`` (20 ms AGC decay, 2^20 samples, one frame a
    block)."""
    c = small.cell("listener_nbfm_nb_2msps", "fm_impulse_quarter_s_blocks",
                   1 << 20, 32768)
    c.name = "small_" + CELL
    return c


def test_the_cell_loads_through_the_harness():
    cell = spec.load_cell(CELL, spec.load_benchmark(REPO), repo=REPO)
    rx = cell.config["receiver"]
    assert cell.config["name"] == "listener_nbfm_nb_2msps"
    assert (rx["mode"], rx["low_cut"], rx["hi_cut"]) == ("fm", -7500.0,
                                                         7500.0)
    assert (rx["nb_on"], rx["nb_threshold"], rx["nb_width_us"]) == \
        (True, 50.0, 20.0)
    assert cell.traffic["block_samples"] == 524288
    assert cell.traffic["capture_samples"] == 134217728
    assert cell.traffic["stations"] == small.FM_STATIONS
    assert cell.chips == 1
    cfg = run.receiver_config(cell.config, cell.traffic)
    assert cfg.frames_per_block == 16 and cfg.block_size == 524288
    assert work.shapes(cell.config, cell.traffic).demod == 16384
    limits = correct.limits_for(CELL, small.ROOT)
    assert set(limits) == set(correct.NUMBERS)
    names = {m["name"] for m in cell.per_layer}
    assert {"blanker_device_ms", "blanker_roofline", "resamp_roofline",
            "pll_linear_pct"} <= names


def _run(hook=None):
    cell = _small()
    if hook is not None:
        hook = hook(cell)
    result, counts = run.run_cell(cell, 2311000001, 1.5, False,
                                  device="cpu",
                                  limits=correct.limits_for(CELL, small.ROOT),
                                  entry_hook=hook)
    return result, counts


def _blanker_off(cell):
    off = copy.deepcopy(cell.config)
    off["receiver"]["nb_on"] = False
    return lambda entry: run.make_entry(
        off, run.receiver_config(off, cell.traffic), "cpu")


@pytest.mark.parametrize("blanker", ["on", "off"])
def test_the_small_cell_is_judged_by_the_reference(blanker):
    result, counts = _run(None if blanker == "on" else _blanker_off)
    assert result["attempted"] > 0 and result["failed"] == 0, result
    assert result["correct"] == (blanker == "on"), result["checks"]
    if blanker == "on":
        tiers = counts["pll_tiers"]["fm"]
        assert tiers["linear"] == result["attempted"], tiers


def _ctx(events, blocks=4):
    cell = spec.load_cell(CELL, spec.load_benchmark(REPO), repo=REPO)
    return trace.Context(events=events, blocks=blocks, window_s=1.0,
                         busy_s=0.5, spans={}, stream_idle=(0.0, 0.0),
                         shapes=work.shapes(cell.config, cell.traffic),
                         layers=spec.load_layers())


GLUE = [("elementwise_kernel", 0.0, 1e-5), ("Memcpy DtoD", 0.0, 2e-5)]


def test_blanker_readers():
    device_ms = spec.load_metric("blanker_device_ms")
    roofline = spec.load_metric("blanker_roofline")
    assert device_ms.read(_ctx(GLUE)) is None
    assert roofline.read(_ctx(GLUE)) is None
    # four blocks of 8 us each: the planes (524,288 samples, 8 bytes a
    # sample) and the 10,000-magnitude history read and written
    ctx = _ctx(GLUE + [("void cutesdr::blanker_kernel(cutesdr::BlankerArgs)",
                        0.0, 8e-6)] * 4)
    assert device_ms.read(ctx) == pytest.approx(8e-3)
    least = (524288 * 8 + 2 * 4 * 10000) / 3.35e12
    assert roofline.read(ctx) == pytest.approx(100 * least / 8e-6)


def test_resamp_roofline_reader():
    reader = spec.load_metric("resamp_roofline")
    assert reader.read(_ctx(GLUE)) is None
    ctx = _ctx(GLUE + [("void cutesdr::resamp_kernel<2, 4, false>()",
                        0.0, 5e-6)] * 4)
    # 16,384 demodulated samples at 62.5 kHz to 48 kHz: 12,582.912 outputs
    # of 28 taps; the bytes' time is the larger
    outputs = 16384 * 48000 / 62500
    nbytes = (28 + 16384) * 4 + outputs * 4
    assert reader.read(ctx) == pytest.approx(100 * nbytes / 3.35e12 / 5e-6)


def test_pll_linear_pct_reader():
    from cutesdr_tpu_torch.demod import fm
    reader = spec.load_metric("pll_linear_pct")
    saved = dict(fm.STATS)
    try:
        fm.STATS.update(linear=0, chunked=0, scan=0)
        assert reader.read(_ctx(GLUE)) is None
        fm.STATS.update(linear=6, chunked=1, scan=1)
        assert reader.read(_ctx(GLUE)) == pytest.approx(75.0)
    finally:
        fm.STATS.update(saved)


def test_the_layer_maps_name_the_kernels():
    layers = spec.load_layers()
    assert layers["blanker"] == {"layer": "blanker",
                                 "kernels": ["blanker_kernel"]}
    assert layers["demod"]["kernels"] == ["fm_chunked_kernel",
                                          "biquad_kernel",
                                          "affine_scan_kernel"]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"][-4:]:
        assert m["workloads"] == [CELL]
