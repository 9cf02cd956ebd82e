"""pll_linear_pct: percent of the window's blocks whose FM PLL held its
linear tier (the verify of the linear solve passed, so K7 returned at
once), counted on the card by the demodulator into ``fm.STATS`` (blocks a
tier), which the harness zeroes as the window opens.  None where no block
took an FM tier."""

UNIT = "%"
LAYER = "demod"
MOVES = "msps"


def read(ctx):
    from cutesdr_tpu_torch.demod import fm
    stats = dict(fm.STATS)
    total = sum(stats.values())
    if "linear" not in stats or not total:
        return None
    return 100.0 * stats["linear"] / total
