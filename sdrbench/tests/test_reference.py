"""The plain reference against the port's CPU path at a small size, for
each configuration (and the FM listener with the blanker, built inline),
and the control against the reference; a configuration that a stage of
the reference has no part for, or two, is refused."""

import pytest

from sdrbench import control, run
from sdrbench.reference import parts
from sdrbench.reference.chain import Reference
from sdrbench.tests import small

CASES = {"listener": small.listener, "bank": small.bank, "fm_nb": small.fm_nb}


@pytest.fixture(scope="module", params=sorted(CASES))
def judged(request):
    cell = CASES[request.param]()
    keep: dict = {}
    # a window of some tens of blocks: a stall of the shared host must not
    # leave it one block, which the check's sample needs two of
    result, counts = run.run_cell(cell, 2026101801, 1.5, False, device="cpu",
                                  limits={}, keep=keep)
    return cell, keep, result, counts


def test_port_matches_reference(judged):
    _, keep, result, _ = judged
    assert result["attempted"] > 0 and result["failed"] == 0, result
    assert len(keep["records"]) >= 2, result["attempted"]
    checks = result["checks"]
    # the port's plain versions in float32: its AGC's and S-meter's
    # averagers stall where a step is below half an ulp (the S-meter's
    # 500 ms decay at -110 dB: within 0.15 dB of its input)
    assert checks["audio_err"]["value"] < 1e-3
    assert checks["smeter_err_db"]["value"] < 0.1


def test_control_fails_where_the_port_passes(judged):
    cell, keep, result, _ = judged
    ctl = control.control_readings(cell, keep, "cpu")
    for k in ("audio_err", "smeter_err_db"):
        assert ctl[k] > 10 * result["checks"][k]["value"], (k, ctl)


def test_warm_up_converges(judged):
    cell, keep, result, _ = judged
    warm2 = control.control_readings(cell, keep, "cpu", 2, "float64")
    assert warm2["audio_err"] < 1e-9
    assert warm2["smeter_err_db"] < 1e-6


@pytest.mark.parametrize("change, stage", [
    ({"mode": "sam"}, "demod"), ({"stereo": True}, "demod"),
    ({"agc_hang": True}, "levels")])
def test_a_stage_with_no_part_is_refused(change, stage):
    cell = small.listener()
    cell.config["receiver"].update(change)
    with pytest.raises(ValueError, match=f"no {stage} part takes mode"):
        Reference(cell.config, cell.traffic["block_samples"])


def test_two_parts_for_a_stage_are_refused(monkeypatch):
    found = parts.listing()
    found["ssb_again"] = found["ssb"]
    monkeypatch.setattr(parts, "listing", lambda: found)
    cell = small.listener()
    with pytest.raises(ValueError, match="demod parts"):
        Reference(cell.config, cell.traffic["block_samples"])
