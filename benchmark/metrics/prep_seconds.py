"""Seconds of the program's k-hop prep of the cell's molecules during
set-up (the benchmark's host span around ``preprocess_graphs``)."""


def read(rec):
    return rec.prep_s
