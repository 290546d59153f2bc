"""device.idle_pct.decode: the share of the traced window in which the card
ran nothing (1 - union of its device intervals over the window), averaged
over the cards the cell uses, in %; decode cells only."""
from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec, "decode")
