"""K1 over the radio's int16 planes, on the CPU.

* The plain version (``mixdec.process_planes_plain``) on int16 planes, one
  stream and a bank's shared and stacked rows, against the same call on
  the planes cast to float32: outputs and carries bitwise.
* The wrapper's route by dtype, with the kernel library stood in for
  (the card is needed to run it): int16 planes call the int16 entry and
  count under ``LAUNCHES["mixdec_int16"]``, float32 planes the float
  entry and ``"mixdec"``.
* csrc/mixdec.cu's int16 staging emulated: which window pairs go as one
  4-byte word a plane and which one sample at a time, over tiles, chunks,
  plane alignments and tail lengths; every window sample staged from its
  own z index, every word read inside the block.

The kernel itself is held bitwise to its float path on the cast planes by
chip_smoke.py (``check_mixdec``, ``check_mixdec_bank``).
"""

import numpy as np
import pytest
import torch

from cutesdr_tpu_torch import kernels
from cutesdr_tpu_torch.design.decimation_plan import plan_decimation
from cutesdr_tpu_torch.kernels import _build, mixdec

torch.set_num_threads(1)


def _wire(rng, shape, scale=3000.0):
    return tuple(torch.from_numpy(np.round(rng.standard_normal(shape) * scale)
                                  .astype(np.int16)) for _ in range(2))


def _bits(t):
    return torch.view_as_real(t).contiguous().view(torch.int32)


def _bank(plan, n_ch, rng):
    """Bank params and a carry with a random raw tail and phases."""
    params, carry = mixdec.init(plan, 0.0, "cpu")
    incs = torch.tensor([(977 * (c + 1) * 65_537) & 0xFFFFFFFF
                         for c in range(n_ch)], dtype=torch.int64)
    t = carry.raw_tail.shape[-1]
    tail = torch.complex(*(torch.from_numpy(
        rng.standard_normal((n_ch, t)).astype(np.float32)) for _ in range(2)))
    return (params._replace(phase_inc=incs),
            mixdec.MixDecCarry(tail, 2**32 - 12345 * torch.arange(
                1, n_ch + 1, dtype=torch.int64)))


@pytest.mark.parametrize("kind,n", [("single", 4096), ("single", 64),
                                    ("shared", 2048), ("stacked", 2048)])
def test_mixdec_plain_int16_matches_cast(kind, n):
    """int16 planes ([n], a bank's shared [n], [C, n] rows; a block
    shorter than the carried tail too) give bitwise the outputs and the
    carry of the same call on the planes cast to float32."""
    rng = np.random.default_rng(5)
    plan = plan_decimation(250_000.0, 20_000.0)
    if kind == "single":
        params, carry = mixdec.init(plan, 31_000.0, "cpu")
        re, im = _wire(rng, n)
    else:
        params, carry = _bank(plan, 3, rng)
        re, im = _wire(rng, n if kind == "shared" else (3, n))
    dc = torch.tensor([0.37 - 0.21j] * (1 if kind == "single" else 3),
                      dtype=torch.complex64).reshape(
        () if kind == "single" else (3,))
    got_c, got = mixdec.process_planes(plan, params, carry, re, im, dc)
    want_c, want = mixdec.process_planes(plan, params, carry, re.float(),
                                         im.float(), dc)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got_c.raw_tail), _bits(want_c.raw_tail))
    assert torch.equal(got_c.phase, want_c.phase)
    assert not any(kernels.LAUNCHES.values())       # CPU: plain version


class _Lib:
    """The kernel library's two K1 entries, recording their calls."""

    def __init__(self):
        self.calls = []

    def cutesdr_mixdec(self, *args):
        self.calls.append(("float", args))
        return 0

    def cutesdr_mixdec_i16(self, *args):
        self.calls.append(("int16", args))
        return 0


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("rows", [None, 2])
def test_mixdec_routes_by_dtype(monkeypatch, wire, rows):
    """On the card the wrapper launches the int16 entry for int16 planes
    (counted as ``mixdec_int16``) and the float entry otherwise (counted
    as ``mixdec``), with the planes' pointers and element and row
    strides; stood in for here, since the kernels need the card."""
    lib = _Lib()
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(mixdec, "_new_carry", lambda *a: None)
    kernels.reset_launches()
    plan = plan_decimation(2e6, 20_000.0)
    rng = np.random.default_rng(7)
    if rows is None:
        params, carry = mixdec.init(plan, 100e3, "cpu")
    else:
        params, carry = _bank(plan, rows, rng)
    n = 32_768
    re, im = _wire(rng, n if rows is None else (rows, n))
    if not wire:
        x = torch.complex(re.float(), im.float())
        re, im = x.real, x.imag
    mixdec.process_planes(plan, params, carry, re, im,
                          torch.zeros((), dtype=torch.complex64))
    [(entry, args)] = lib.calls
    assert entry == ("int16" if wire else "float")
    assert args[:2] == (re.data_ptr(), im.data_ptr())
    cs = 0 if rows is None else re.stride(0)
    assert args[2:6] == (cs, cs, re.stride(-1), im.stride(-1))
    counted = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert counted == {("mixdec_int16" if wire else "mixdec"): 1}
    kernels.reset_launches()


def _staged(n_out, dec, ntaps, tail_len, off, tile_out):
    """The window csrc/mixdec.cu stages from int16 planes, tile by tile and
    chunk by chunk: each thread's pair of elements e, e+1 (e even) either
    as one 4-byte word a plane (both samples in the block and in the
    window, the word aligned: the planes start ``off`` samples past a
    4-byte boundary) or one sample at a time.  Checks every staged value
    is the z sample of its own element, zero past the window, and every
    word lies inside the block; returns (block samples staged, of them
    staged as words)."""
    P = mixdec.lanes(dec)
    lg = P.bit_length() - 1
    K = -(-ntaps // dec)
    n = n_out * dec
    zval = np.arange(tail_len + n) + 1          # z sample i holds i + 1
    block, packed_total = 0, 0
    for o0 in range(0, n_out, tile_out):
        outs = min(tile_out, n_out - o0)
        z0, wlen = o0 * dec, (outs - 1) * dec + ntaps
        nwin = (tile_out + K) * P
        for c in range(dec // P):
            e = np.arange(0, nwin, 2)
            idx = lambda el: (el >> lg) * dec + c * P + (el & (P - 1))
            i = idx(e)
            zi = z0 + i
            two = e + 1 < nwin
            k = zi - tail_len
            packed = (zi >= tail_len) & two & (i + 1 < wlen) & (
                (off + k) % 2 == 0)
            # a word holds samples k, k + 1 of the block
            assert (k[packed] >= 0).all() and (k[packed] + 1 < n).all()
            for h in (0, 1):
                el = e + h
                live = el < nwin
                ih = idx(el)
                want = np.where(ih < wlen, zval[np.minimum(z0 + ih,
                                                          len(zval) - 1)], 0)
                # the word's half h, or the sample's own read
                got = np.where(packed, zval[np.where(packed, zi + h, 0)],
                               np.where(i + h < wlen,
                                        zval[np.minimum(zi + h,
                                                        len(zval) - 1)], 0))
                assert np.array_equal(got[live], want[live])
                inblock = live & (ih < wlen) & (z0 + ih >= tail_len)
                block += int(inblock.sum())
                packed_total += int((packed & inblock).sum())
    return block, packed_total


@pytest.mark.parametrize("n_out,dec,ntaps,tail_len,tile_out", [
    (1024, 32, 1063, 1062, 32),      # the session's one-frame block
    (2048, 32, 1063, 1062, 256),     # the flagship's tiles
    (1024, 128, 3127, 3126, 128),    # the 64-channel bank
    (1024, 128, 1506, 1502, 128),    # the CW plan (d = 3)
    (1000, 4, 123, 122, 512),        # a 250 kHz input, a partial tile
    (777, 2, 51, 50, 768), (4096, 1, 1, 0, 1024),
    (600, 2, 52, 51, 512)])          # an odd tail
@pytest.mark.parametrize("off", [0, 1])
def test_mixdec_int16_staging_emulated(n_out, dec, ntaps, tail_len,
                                       tile_out, off):
    """Every window sample staged once from its z index over the tail and
    the int16 block; where the planes and the tail leave the block's pairs
    word-aligned, all but the window edges' go as words, and none where
    they do not."""
    block, packed = _staged(n_out, dec, ntaps, tail_len, off, tile_out)
    if (off + tail_len) % 2 == 0:
        assert packed >= 0.9 * block
    else:
        assert packed == 0
