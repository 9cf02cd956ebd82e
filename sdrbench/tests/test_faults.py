"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a cell can have, and the FM listener's with its
blanker off; the same run unbroken reads true under the shipped limits.
The harness's look for a card is skipped (the port runs its CPU path)."""

import copy

import pytest
import torch

from sdrbench import correct, run
from sdrbench.tests import small

# the shipped limits of a cell, or a configuration's limits given here
# where it has no cell yet: the bank's, as read on the card at 4-frame
# blocks (PERF.md, "Open questions"); the FM listener's between the CPU
# path's readings at this size over a dozen seeds and the control's
# (PERF.md, "Findings")
CELLS = {"listener": (small.listener, "usb_capture"),
         "bank": (small.bank, {"audio_err": 0.08, "smeter_err_db": 1.4}),
         "fm_nb": (small.fm_nb, {"audio_err": 2e-4, "smeter_err_db": 0.02})}


class Broken:
    """An entry whose outputs, or whose state, a fault changes."""

    def __init__(self, entry, fault):
        self.entry, self.fault = entry, fault
        self.start = _clone(entry.carry)

    def process_planes(self, re, im):
        if self.fault == "state_unchanged":
            self.entry.carry = _clone(self.start)
        out = self.entry.process_planes(re, im)
        audio = out.audio.clone()
        if self.fault == "half_left_out":
            if audio.dim() == 2:             # a bank: half of its channels
                audio[audio.shape[0] // 2:] = 0
            else:                            # a stream: half of its block
                audio[audio.shape[-1] // 2:] = 0
            return out._replace(audio=audio)
        if self.fault == "audio_altered":       # its largest sample lost
            flat = audio.reshape(-1)
            flat[flat.abs().argmax()] = 0
            return out._replace(audio=audio)
        if self.fault == "smeter_altered":      # one S-unit off
            return out._replace(smeter_ave_db=out.smeter_ave_db + 6.0)
        return out


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [_clone(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _blanker_off(cell):
    """A hook that swaps the entry for one of the same configuration with
    the noise blanker off."""
    off = copy.deepcopy(cell.config)
    off["receiver"]["nb_on"] = False
    return lambda entry: run.make_entry(
        off, run.receiver_config(off, cell.traffic), "cpu")


def _run(which, fault):
    make, limits = CELLS[which]
    if isinstance(limits, str):
        limits = correct.limits_for(limits, small.ROOT)
    cell = make()
    if fault is None:
        hook = None
    elif fault == "blanker_off":
        hook = _blanker_off(cell)
    else:
        hook = lambda e: Broken(e, fault)  # noqa: E731
    result, _ = run.run_cell(cell, 777, 0.5, False, device="cpu",
                             limits=limits, entry_hook=hook)
    return result


@pytest.mark.parametrize("which", sorted(CELLS))
def test_unbroken_is_correct(which):
    result = _run(which, None)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "audio_altered", "smeter_altered"])
@pytest.mark.parametrize("which", sorted(CELLS))
def test_broken_is_not_correct(which, fault):
    result = _run(which, fault)
    assert not result["correct"], result["checks"]


def test_blanker_off_is_not_correct():
    result = _run("fm_nb", "blanker_off")
    assert not result["correct"], result["checks"]
