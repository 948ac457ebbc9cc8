"""The port's public API against the JAX package's.

* every subpackage's and the top level's exported names: the JAX
  package's, less the JAX-only forms each port ``__init__`` lists in its
  docstring; every name resolves, and importing the package with JAX
  blocked starts no process (builds nothing);
* ``make_norm``, ``k_fold_unstratified``, ``FeatureSumEncoder`` (carried
  weights both ways) and ``count_parameters`` (the flagship's and CSL's
  KPGIN trees) against their JAX twins;
* ``union_in_degree`` on a node-sharded flagship-shaped batch at P=2
  against the JAX call on the JAX partition, rank by rank;
* the store builders default to the card, and the top-level names train
  on the CPU.

Tolerances: FeatureSumEncoder f32 atol 1e-6 (one-hot matmuls that add
at most two rows); everything else exact.
"""
import dataclasses
import importlib
import inspect
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.models as jmodels
import kpgnn_tpu_torch as kt
from kpgnn_tpu.nn.encoders import FeatureSumEncoder as JFeatureSumEncoder
from kpgnn_tpu.nn.norms import make_norm as jmake_norm
from kpgnn_tpu.ops.adjacency import union_in_degree as junion
from kpgnn_tpu.parallel.partition import partition_batch as jpartition
from kpgnn_tpu.train.kfold import k_fold_unstratified as jk_fold
from kpgnn_tpu.train.state import count_parameters as jcount
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.nn.encoders import FeatureSumEncoder
from kpgnn_tpu_torch.nn.inits import init_parameters
from kpgnn_tpu_torch.nn.norms import make_norm
from kpgnn_tpu_torch.ops.adjacency import union_in_degree
from kpgnn_tpu_torch.parallel.partition import partition_batch
from kpgnn_tpu_torch.scripts import common, train_csl, train_zinc
from kpgnn_tpu_torch.train import resident
from kpgnn_tpu_torch.train.kfold import k_fold_unstratified
from kpgnn_tpu_torch.train.loop import _masked_loss
from kpgnn_tpu_torch.train.state import count_parameters
from kpgnn_tpu_torch.utils.convert import (embedding_modules,
                                           params_from_flax, params_to_flax)
from tests.test_torch_layers import flat
from tests.test_torch_prep_batch import ZINC_PREP, both_prep, raw_molecules

torch.set_num_threads(1)

SUBPACKAGES = ["graph", "prep", "ops", "nn", "models", "train", "data",
               "parallel", "utils", "scripts"]
# names the JAX package exports whose form is JAX's own (flax
# initializers and state, jit step factories, shard_map inputs), and
# utils' wall-clock block timer, which the port's spans replace; each
# port __init__ names them in its docstring with the port's counterpart
JAX_ONLY = {
    "nn": {"torch_linear_kernel_init", "torch_linear_bias_init",
           "kaiming_uniform", "normal_init"},
    "train": {"TrainState", "create_train_state", "make_train_step",
              "make_eval_step"},
    "parallel": {"stack_batches", "batch_pspecs"},
    "utils": {"timed"},
}
# the process group and the eval step of one process a rank
PORT_ONLY = {"parallel": {"Mesh", "spawn", "make_parallel_eval_step"}}


def public_names(mod):
    """``__all__``, or the module's public non-module attributes where it
    has none (the JAX top level)."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("sub", [""] + SUBPACKAGES)
def test_exports_match_the_jax_package(sub):
    jmod = importlib.import_module("kpgnn_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module(
        "kpgnn_tpu_torch" + (f".{sub}" if sub else ""))
    jonly = JAX_ONLY.get(sub, set())
    if sub == "scripts":        # neither package exports names there
        assert not hasattr(jmod, "__all__") and not hasattr(tmod, "__all__")
        return
    want = public_names(jmod) - jonly | PORT_ONLY.get(sub, set())
    got = set(tmod.__all__)
    assert got == want, (sorted(got - want), sorted(want - got))
    assert jonly <= public_names(jmod)
    for name in sorted(jonly):
        assert name not in dir(tmod) and name in tmod.__doc__, name
    for name in sorted(got):
        obj = getattr(tmod, name)
        if callable(obj) and hasattr(obj, "__module__"):
            assert obj.__module__.startswith("kpgnn_tpu_torch."), name


def test_top_level_names_are_the_subpackages_objects():
    assert (kt.Trainer is kt.train.Trainer and kt.Graph is kt.graph.Graph
            and kt.make_model is kt.models.make_model
            and kt.extract_khop is kt.prep.extract_khop)
    assert kt.data.COUNTING_TASKS is kt.data.counting.TASKS
    assert kt.train.count_parameters is count_parameters


def test_import_with_jax_blocked_starts_no_process():
    """The acceptance import: no JAX, networkx or matplotlib, and no
    compiler run (a build would start one)."""
    code = (
        "import sys, subprocess\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'kpgnn_tpu',\n"
        "          'networkx', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'started a process: {a}')\n"
        "subprocess.Popen.__init__ = refuse\n"
        "import kpgnn_tpu_torch as kt\n"
        "kt.Trainer; kt.make_model; kt.train.k_fold_unstratified\n"
        "kt.nn.make_norm; kt.nn.FeatureSumEncoder\n"
        "kt.train.count_parameters\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("key", ["Batch", "Layer", "Instance", "GraphSize",
                                 "Pair", "Group"])
def test_make_norm_matches_jax(key):
    if key == "Group":
        for fn in (make_norm, jmake_norm):
            with pytest.raises(ValueError, match="Not supported norm"):
                fn(key)
        return
    cls = make_norm(key)
    assert cls.__name__ == jmake_norm(key).__name__
    assert cls is getattr(kt.nn, cls.__name__)


@pytest.mark.parametrize("n", [10, 37, 188])
@pytest.mark.parametrize("folds", [3, 10])
@pytest.mark.parametrize("seed", [12345, 7])
def test_k_fold_unstratified_array_equal(n, folds, seed):
    ours, theirs = (k_fold_unstratified(n, folds, seed),
                    jk_fold(n, folds, seed))
    assert len(ours) == len(theirs) == folds
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("padding", [False, True])
def test_feature_sum_encoder_carried_weights(padding):
    dims, H = [5, 9, 3], 16
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, d, 40) for d in dims], -1).astype(np.int32)
    jm = JFeatureSumEncoder(dims, H, padding=padding)
    v = jm.init(jax.random.PRNGKey(1), x)
    tm = FeatureSumEncoder(dims, H, padding=padding)
    tm.load_state_dict(params_from_flax(flat(v)), strict=True)
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jm.apply(v, x)), atol=1e-6,
                               rtol=0)
    if padding:             # row 0 of every table reads zero
        assert torch.equal(tm(torch.zeros(1, 3, dtype=torch.int32)),
                           torch.zeros(1, H))
    back = params_to_flax(tm.state_dict(), embedding_modules(tm))
    assert back.keys() == flat(v).keys()
    for k, a in flat(v).items():
        np.testing.assert_array_equal(back[k], a)
    again = params_from_flax(back)
    assert all(torch.equal(again[k], t) for k, t in tm.state_dict().items())


def script_config(script, argv, **kw):
    return common.model_config(script.parser().parse_args(argv), **kw)


def flat_shapes(variables):
    """Flax variables of ShapeDtypeStructs -> ('coll/a/b/leaf', shape)."""
    import flax
    for coll, tree in variables.items():
        for k, s in flax.traverse_util.flatten_dict(tree).items():
            yield coll + "/" + "/".join(map(str, k)), s


FLAGSHIP = (train_zinc, ["--combine", "attention", "--residual"],
            dict(input_encoder=("embedding", 21), task="graph_regression",
                 output_size=1))
CSL = (train_csl, [], dict(input_encoder=("linear", 1),
                           task="graph_classification", output_size=10))


@pytest.mark.parametrize("script,argv,kw", [FLAGSHIP, CSL],
                         ids=["flagship", "csl"])
def test_count_parameters_matches_jax(script, argv, kw):
    """The port's count equals the JAX count of the flax tree at the
    script's full width, and the tree carries into the port's model
    strictly (the same elements: no buffer counted on either side)."""
    cfg = script_config(script, argv, **kw)
    prep = dict(ZINC_PREP, K=cfg.K, max_edge_attr_num=cfg.max_pe_num)
    js, _ = both_prep(raw_molecules(2, seed=3), **prep)
    jmodel = jmodels.make_model(jmodels.ModelConfig(**dataclasses.asdict(
        cfg)))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jbatch.collate(js), train=False))
    tmodel = kt.make_model(cfg)
    tmodel.load_state_dict(params_from_flax(
        {k: np.zeros(s.shape, s.dtype) for k, s in flat_shapes(shapes)}),
        strict=True)
    assert count_parameters(tmodel) == jcount(shapes["params"]) > 0


def test_union_in_degree_on_a_node_shard_matches_jax():
    js, ts = both_prep(raw_molecules(6, seed=9), **ZINC_PREP)
    pads = dict(n_pad=256, e_pad=sum(g.num_edges for g in ts) + 8, g_pad=7)
    jb, tb = jbatch.collate(js, **pads), tbatch.collate(ts, **pads)
    P = 2
    jadj = jpartition(jb, P).adj
    degs = []
    for rank in range(P):
        shard = partition_batch(tb, P, rank).adj
        jshard = jadj.replace(**{f: getattr(jadj, f)[rank:rank + 1]
                                 for f in ("senders", "receivers",
                                           "edge_attr", "edge_mask",
                                           "send_rows")})
        got = union_in_degree(shard)
        assert got.shape == (shard.n_local,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(junion(jshard)))
        degs.append(got)
    # the shards' degrees are the whole batch's
    np.testing.assert_array_equal(torch.cat(degs).numpy(),
                                  union_in_degree(tb.adj).numpy())


@pytest.mark.parametrize("builder", ["build_dense_store", "build_coo_store",
                                     "build_banded_store"])
def test_store_builders_default_to_the_card(builder):
    fn = getattr(resident, builder)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, ts = both_prep(raw_molecules(3, seed=2), K=2)
    args = {"build_dense_store": (ts, 40, 4, 4),
            "build_coo_store": (ts,),
            "build_banded_store": (ts, 4, 4)}[builder]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(*args)
    assert fn(*args, device="cpu").nbytes() > 0


def test_top_level_names_train_on_the_cpu():
    """The package docstring's flow: kt.extract_khop -> kt.GraphLoader ->
    kt.make_model(kt.ModelConfig) -> kt.Trainer on the CPU; its first
    step's loss is the model's loss on the loader's first batch."""
    raws = raw_molecules(12, seed=5)
    khop = kt.KHopConfig(K=2, max_edge_attr_num=5)
    graphs = [kt.extract_khop(r["num_nodes"], r["edge_index"],
                              r["edge_attr"], khop, x=r["x"], y=r["y"])
              for r in raws]
    cfg = kt.ModelConfig(model_name="KPGINPlus", K=2, num_layer=2,
                         hidden_size=8, num_hop1_edge=3, max_pe_num=5,
                         input_encoder=("embedding", 21),
                         task="graph_regression")
    loader = kt.GraphLoader(graphs, 4, mode="pallas", v1=5, vk=7)
    rows = []
    model, _ = kt.Trainer(kt.make_model(cfg), kt.TrainConfig(num_epochs=1),
                          device="cpu").fit(
        loader, seed=3, epoch_callback=lambda e, m, row: rows.append(row))
    first = next(iter(loader))
    ref = init_parameters(kt.make_model(cfg), 3)
    with torch.no_grad():
        lsum, cnt = _masked_loss(ref(first, train=True), first.y,
                                 first.graph_mask, "l1")
    assert len(rows) == 1 and len(rows[0]["step_losses"]) == 3
    np.testing.assert_allclose(rows[0]["step_losses"][0],
                               float(lsum / cnt), rtol=1e-6)
