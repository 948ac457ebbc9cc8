"""Traffic: each mix is a data file (``<mix>.json``: its ``kind``,
backend, batch size and library), and each kind is a module
(``<kind>.py``) that the mix names.  A kind module gives:

* ``PROFILE_STEPS``: the steps a ``--trace 1`` run profiles;
* optionally ``CALIBRATE``: molecules over which the norms' running
  statistics are set before both sides get the weights;
* ``window(cell) -> dict``: set-up past the model, warm-up and the
  measured window (``drive.Cell``); returns what ``check`` compares;
* ``check(cfg, tr, raw, P0, got, device) -> (numbers, line)``: the
  plain reference's run over the same raw molecules and weights, once
  the program's state is freed;
* ``control(cfg, tr, seed, device) -> numbers``: the reference in the
  program's place in the next precision below the configuration's.
"""
