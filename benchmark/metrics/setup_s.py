"""Seconds from the process's start to the window's first step: imports,
nvcc on a checkout's first run, data, prep, collate or cache fill, model
and warm-up."""


def read(rec):
    return rec.setup_s
