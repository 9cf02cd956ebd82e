"""k4_rounds: guess-verify rounds a solve of the two-rate AGC's averagers
(K4), counted on the card by the solve kernels into ``agc.STATS``
(``solve_rounds`` over ``solves``), which the harness zeroes as the
window opens."""

UNIT = "rounds/solve"
LAYER = "levels"
MOVES = "msps"


def read(ctx):
    from cutesdr_tpu_torch.ops import agc
    if "solves" not in list(agc.STATS):
        return None
    solves = agc.STATS["solves"]
    return agc.STATS["solve_rounds"] / solves if solves else None
