"""Cells cut to a size the CPU runs in seconds: the widths stay, the corpus
shrinks. Used by the tests that drive whole runs."""

from benchmark import harness


def cell(name: str) -> harness.Cell:
    c = harness.Cell(name)
    if name == "dim_corpus_cold":
        c.traffic.update(files=6, seconds_lo=3.0, seconds_hi=5.0, batch_size=4)
    elif name == "dim_files_open":
        c.traffic.update(pool_files=4, seconds_lo=3.0, seconds_hi=4.0, rate_per_s=2.0)
    else:
        c.config["corpus"].update(train_files=12, val_files=4, seconds_lo=3.0, seconds_hi=4.0)
        c.config["yaml"].update(tr_bs=4, tr_bs_val=4, tr_verbose=0)
    return c
