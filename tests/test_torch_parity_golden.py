"""The port's golden-bundle writer against the JAX package's bundles.

* ``params_to_flax`` inverts ``params_from_flax`` bit for bit on each of
  the seven committed goldens (kpgnn_tpu/data/parity_golden);
* a port bundle has the JAX golden's keys and shapes, less the flax-only
  ``FeatureConcatEncoder`` child captures (``FLAX_ONLY``);
* the JAX package reads a port bundle: its parameters, unflattened into
  flax variables, run through the JAX package's own prep, collate,
  ``make_model`` and ``capture_activations`` on the bundle's raw graph,
  reproduce every stored activation and the output (the attention
  LSTM's output in the bundles' node-major layout);
* ``main --all --device cpu`` writes the seven bundles, and the port's
  ``replay_bundle`` reproduces each within 1e-6.

Tolerances (f32): activations atol 1e-5 / rtol 1e-4 across the two
frameworks (they sum in different orders); parameters exact.
"""
import json
import os

import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.scripts import make_parity_golden as mpg
from kpgnn_tpu_torch.utils.convert import (embedding_modules,
                                           params_from_flax, params_to_flax)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "kpgnn_tpu", "data", "parity_golden")
NAMES = sorted(mpg.CONFIGS)
ACT = dict(atol=1e-5, rtol=1e-4)


def golden(name):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))


def model_config(a):
    return dict(
        model_name=a["model_name"], hidden_size=a["hidden_size"],
        num_layer=a["num_layer"], K=a["K"], kernel=a["kernel"],
        num_hop1_edge=a["num_hop1_edge"], max_pe_num=a["max_pe_num"],
        max_edge_type=a["max_edge_type"],
        max_edge_count=a["max_edge_count"], max_hop_num=a["max_hop_num"],
        max_distance_count=a["max_distance_count"], JK=a["JK"],
        combine=a["combine"], residual=a["residual"], aggr=a["aggr"],
        virtual_node=a["virtual_node"], use_rd=a["use_rd"],
        num_l1_layer=a["num_l1_layer"],
        input_encoder=("embedding", a["input_size"]),
        task="graph_classification", output_size=a["output_size"],
        pooling_method=a["pooling_method"], norm_type=a["norm_type"])


def variable_keys(files):
    return {k for k in files if k.startswith(("params/", "batch_stats/"))}


def test_bundle_configs_are_the_jax_scripts():
    from kpgnn_tpu.scripts import make_parity_golden as jmpg
    assert mpg.BASE_ARGS == jmpg.BASE_ARGS
    assert mpg.CONFIGS == jmpg.CONFIGS
    for ours, theirs in zip(mpg.tiny_graph(), jmpg.tiny_graph()):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("name", NAMES)
def test_params_to_flax_inverts_params_from_flax(name):
    g = golden(name)
    a = json.loads(bytes(g["meta"]).decode())
    model = make_model(ModelConfig(**model_config(a)))
    sd = params_from_flax({k: g[k] for k in g.files})
    model.load_state_dict(sd, strict=True)
    flat = params_to_flax(model.state_dict(), embedding_modules(model))
    assert set(flat) == variable_keys(g.files)
    for k, v in flat.items():
        assert v.dtype == g[k].dtype and np.array_equal(v, g[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_port_bundle_has_the_jax_keys_and_shapes(name):
    g = golden(name)
    out = mpg.build_bundle(dict(mpg.BASE_ARGS, **mpg.CONFIGS[name]), "cpu")
    assert set(mpg.FLAX_ONLY) <= set(g.files)
    assert set(out) == set(g.files) - set(mpg.FLAX_ONLY)
    for k, v in out.items():
        assert v.shape == g[k].shape, k
    np.testing.assert_array_equal(out["meta"], g["meta"])
    for k in ("raw/n", "raw/edge_index", "raw/edge_attr", "raw/x",
              "act/__node_mask__"):
        np.testing.assert_array_equal(out[k], g[k])


def jax_reads_bundle(bundle):
    """The JAX package's activations of the bundle's raw graph under the
    bundle's parameters, captured as the JAX script captures them."""
    import flax
    import jax.numpy as jnp
    from kpgnn_tpu.graph.batch import collate
    from kpgnn_tpu.models import ModelConfig as JModelConfig
    from kpgnn_tpu.models import make_model as jmake_model
    from kpgnn_tpu.prep import KHopConfig, extract_khop
    from kpgnn_tpu.utils.parity import capture_activations

    a = json.loads(bytes(bundle["meta"]).decode())
    kcfg = KHopConfig(K=a["K"], kernel=a["kernel"],
                      max_edge_attr_num=a["max_edge_attr_num"],
                      max_hop_num=a["max_hop_num"],
                      max_edge_type=a["max_edge_type"],
                      max_edge_count=a["max_edge_count"],
                      max_distance_count=a["max_distance_count"],
                      use_rd=a["use_rd"])
    n = int(bundle["raw/n"][0])
    g = extract_khop(n, bundle["raw/edge_index"], bundle["raw/edge_attr"],
                     kcfg, x=bundle["raw/x"], y=np.array([0], np.int64))
    batch = collate([g], n_pad=n + 1, e_pad=g.num_edges + 8, g_pad=2)
    model = jmake_model(JModelConfig(**model_config(a)))
    variables = {}
    for key in variable_keys(bundle):
        coll, rest = key.split("/", 1)
        variables.setdefault(coll, {})[rest] = jnp.asarray(bundle[key])
    variables = {c: flax.traverse_util.unflatten_dict(v, sep="/")
                 for c, v in variables.items()}
    acts = capture_activations(model, variables, batch)
    acts["__output__"] = np.asarray(
        model.apply(variables, batch, train=False))[:1]
    acts["__node_mask__"] = np.asarray(batch.node_mask)
    return acts


@pytest.mark.parametrize("name", NAMES)
def test_jax_package_reads_a_port_bundle(name):
    out = mpg.build_bundle(dict(mpg.BASE_ARGS, **mpg.CONFIGS[name]), "cpu")
    acts = jax_reads_bundle(out)
    stored = {k[len("act/"):] for k in out if k.startswith("act/")}
    # every port capture is a JAX capture; the JAX side's extra keys are
    # exactly the flax-only encoder children
    assert stored <= set(acts)
    assert {"act/" + k for k in set(acts) - stored} == set(mpg.FLAX_ONLY)
    for k in sorted(stored):
        want = acts[k]
        if k.endswith("attention_lstm/__call__") and (
                want.shape != out["act/" + k].shape):
            # the JAX KPGINPlusConv runs its attention LSTM time-major
            # since its hop-major layout; the bundles (its committed
            # goldens too) keep the node-major (N, K, 2H)
            want = want.transpose(1, 0, 2)
        np.testing.assert_allclose(out["act/" + k], want, err_msg=k, **ACT)
    assert len(stored) >= 15


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    return mpg.main(["--all", "--out_dir", str(d), "--device", "cpu"])


def test_main_all_writes_seven_bundles(written):
    assert [os.path.basename(p) for p in written] == [
        f"{n}.npz" for n in NAMES]
    assert all(os.path.isfile(p) for p in written)


@pytest.mark.parametrize("name", NAMES)
def test_replay_of_a_port_bundle(written, name):
    path = written[NAMES.index(name)]
    assert mpg.replay_bundle(path, device="cpu") <= 1e-6
