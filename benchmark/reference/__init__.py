"""The plain references: the k-hop prep (``prep.py``), what every model
shares (``common.py``), and one module per model, named after the
configuration's ``model_name`` in lower case, with ``param_spec(m)``
and ``forward(P, batch, m, train, stats=None)``."""
import importlib


def for_model(model_name: str):
    """The reference module of ``model_name`` (``KPGINPlus`` ->
    ``kpginplus.py``)."""
    return importlib.import_module(f"{__name__}.{model_name.lower()}")
