"""The port stands alone: it imports neither JAX nor the JAX package nor
networkx (the H100 machine has no networkx; the graph families are the
port's own copies), and its entry points never fall back to the CPU
silently."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kpgnn_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "optax", "kpgnn_tpu", "networkx")


def port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_or_jax_package():
    sources = port_sources()
    assert len(sources) > 20
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in imported_modules(p)
           if m.split(".")[0] in BANNED]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {BANNED!r}: sys.modules[m] = None\n"
        "import kpgnn_tpu_torch\n"
        "for info in pkgutil.walk_packages(kpgnn_tpu_torch.__path__,\n"
        "                                  'kpgnn_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_train_zinc_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from kpgnn_tpu_torch.scripts import train_zinc

    with pytest.raises(RuntimeError, match="--device cpu"):
        train_zinc.main(["--dataset_dir", str(tmp_path), "--save_dir",
                         str(tmp_path / "s"), "--backend", "pallas"])
    assert not (tmp_path / "s").exists()


def test_train_qm9_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from kpgnn_tpu_torch.scripts import train_qm9

    for backend in ("pallas", "dense"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_qm9.main(["--dataset_dir", str(tmp_path), "--save_dir",
                            str(tmp_path / "s"), "--backend", backend])
    assert not (tmp_path / "s").exists()


def test_isolation_checks_cover_the_qm9_and_dense_modules():
    """The QM9 script, the molecule loaders and the dense backend are among
    the sources both isolation checks read and import."""
    sources = {os.path.relpath(p, REPO) for p in port_sources()}
    for mod in ("scripts/train_qm9.py", "data/molecules.py",
                "ops/adjacency.py", "graph/batch.py", "nn/encoders.py"):
        assert os.path.join("kpgnn_tpu_torch", mod) in sources, mod
    from kpgnn_tpu_torch.data.molecules import QM9_CONVERSION
    from kpgnn_tpu_torch.ops.adjacency import DenseAdj
    assert QM9_CONVERSION.shape == (19,) and DenseAdj.__module__.startswith(
        "kpgnn_tpu_torch.")


@pytest.mark.parametrize("script,argv", [
    ("train_counting", ["--n_graphs", "20"]),
    ("train_graph_property", ["--data_scale", "0.02"]),
    ("train_node_property", ["--data_scale", "0.02"]),
    ("train_tu", ["--dataset_name", "NOWHERE"])])
def test_generated_data_scripts_without_cuda_raise(tmp_path, script, argv):
    """The default device is cuda: without CUDA each script raises before
    it generates, loads or writes anything; --device cpu runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import importlib
    mod = importlib.import_module(f"kpgnn_tpu_torch.scripts.{script}")
    for backend in ("pallas", "coo", "dense"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            mod.main(argv + ["--save_dir", str(tmp_path / "s"),
                             "--dataset_dir", str(tmp_path), "--backend",
                             backend])
    assert not (tmp_path / "s").exists()


def test_isolation_checks_cover_the_generated_data_modules():
    """The generators, oracles, TU parsers, node heads and the four new
    scripts are among the sources both isolation checks read and
    import."""
    sources = {os.path.relpath(p, REPO) for p in port_sources()}
    for mod in ("data/generation.py", "data/algorithms.py",
                "data/counting.py", "data/property.py", "data/tu.py",
                "models/heads.py", "train/lr.py", "scripts/train_counting.py",
                "scripts/train_graph_property.py",
                "scripts/train_node_property.py", "scripts/train_tu.py"):
        assert os.path.join("kpgnn_tpu_torch", mod) in sources, mod
    from kpgnn_tpu_torch.data.generation import generate_graph
    from kpgnn_tpu_torch.models.heads import NodeRegression
    assert generate_graph.__module__ == "kpgnn_tpu_torch.data.generation"
    assert NodeRegression.__module__.startswith("kpgnn_tpu_torch.")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from kpgnn_tpu_torch.ops import cuda_lib

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cuda_lib, "NVCC_FALLBACK", "/nonexistent/nvcc")
    monkeypatch.setattr(cuda_lib, "BUILD_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.build("gather_segment_sum.cu")
    assert not any(tmp_path.iterdir())      # nothing half-built left


def test_isolation_checks_cover_the_bf16_resident_and_prep_modules():
    """The synthetic generators, the native prep and its C++ source, the
    prep runner and the resident stores are among the sources both
    isolation checks read and import."""
    sources = {os.path.relpath(p, REPO) for p in port_sources()}
    for mod in ("data/synthetic.py", "prep/native.py", "prep/runner.py",
                "train/resident.py"):
        assert os.path.join("kpgnn_tpu_torch", mod) in sources, mod
    from kpgnn_tpu_torch.prep import native
    assert os.path.isfile(native.SOURCE)
    assert native.SOURCE.startswith(os.path.join(PKG, ""))


def test_native_prep_builds_from_the_ports_source_with_jax_blocked(
        tmp_path):
    """A fresh build, in a process where the JAX package cannot be
    imported, compiles the port's copy of the C++ source into the given
    build root and loads that library, never the JAX package's."""
    code = (
        "import sys\n"
        f"for m in {BANNED!r}: sys.modules[m] = None\n"
        "from kpgnn_tpu_torch.prep import native\n"
        f"native.BUILD_ROOT = {str(tmp_path)!r}\n"
        "assert native.available(), native.BUILD_ERROR\n"
        "assert native.BUILD_SECONDS > 0\n"
        "print(native._lib._name)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    from kpgnn_tpu_torch.prep import native
    assert proc.stdout.strip() == os.path.join(
        str(tmp_path), native.source_hash(), "libkhop_native.so")


def test_native_prep_without_gxx_is_unavailable(monkeypatch, tmp_path):
    """Without g++ the build raises, nothing half-built is left, and
    ``available()`` says False with the reason: prep takes the numpy
    path, which gives the same graphs."""
    from kpgnn_tpu_torch.prep import native

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build()
    assert not any(p.is_file() for p in tmp_path.rglob("*"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setattr(native, "BUILD_ERROR", None)
    assert not native.available()
    assert "g++" in native.BUILD_ERROR


def test_isolation_checks_cover_the_expressiveness_and_observability_modules():
    """The checkpoint, EMA, seed, meter, profiling, trace-summary and
    parity modules, the EXP/SR25 loaders and the five new scripts are
    among the sources both isolation checks read and import."""
    sources = {os.path.relpath(p, REPO) for p in port_sources()}
    for mod in ("train/checkpoint.py", "train/ema.py", "utils/seed.py",
                "utils/meters.py", "utils/profiling.py",
                "utils/trace_summary.py", "utils/parity.py",
                "data/expressiveness.py", "scripts/train_exp.py",
                "scripts/train_sr.py", "scripts/run_simulation.py",
                "scripts/run_search.py", "scripts/profile_step.py"):
        assert os.path.join("kpgnn_tpu_torch", mod) in sources, mod
    from kpgnn_tpu_torch.data.expressiveness import load_sr25
    from kpgnn_tpu_torch.train.checkpoint import CheckpointSaver
    assert load_sr25.__module__ == "kpgnn_tpu_torch.data.expressiveness"
    assert CheckpointSaver.__module__ == "kpgnn_tpu_torch.train.checkpoint"


def test_port_imports_without_matplotlib_or_networkx():
    """Importing every module of the port loads neither matplotlib (the
    simulation's sweep draws only where it imports, inside the call) nor
    networkx, and works where both are blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import kpgnn_tpu_torch\n"
        "for info in pkgutil.walk_packages(kpgnn_tpu_torch.__path__,\n"
        "                                  'kpgnn_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.split('.')[0] in ('matplotlib', 'networkx'))\n"
        "print(bad)\n")
    for blocked in ((), ("matplotlib", "networkx")):
        pre = "".join(f"import sys; sys.modules[{m!r}] = None\n"
                      for m in blocked)
        proc = subprocess.run([sys.executable, "-c", pre + code], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("script,argv", [
    ("train_exp", ["--folds", "2"]),
    ("train_sr", []),
    ("run_simulation", ["--n", "10", "--graphs", "1"]),
    ("profile_step", ["--stages", "large"]),
    ("profile_step", ["--stages", "banded"]),
    ("tune_banded", ["--n_nodes", "256"])])
def test_expressiveness_scripts_without_cuda_raise(tmp_path, script, argv):
    """The default device is cuda: without CUDA each new script raises
    before it loads, generates or writes anything; --device cpu runs
    (tests/test_torch_expressiveness_scripts.py,
    tests/test_torch_observability.py)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import importlib
    mod = importlib.import_module(f"kpgnn_tpu_torch.scripts.{script}")
    timing = script in ("profile_step", "tune_banded")
    if script == "profile_step":
        argv = argv + ["--out_dir", str(tmp_path / "s")]
    elif not timing:
        argv = argv + ["--save_dir", str(tmp_path / "s"), "--dataset_dir",
                       str(tmp_path)]
    for backend in (("pallas", "coo") if not timing else (None,)):
        with pytest.raises(RuntimeError, match="--device cpu"):
            mod.main(argv + (["--backend", backend] if backend else []))
    assert not (tmp_path / "s").exists()


def test_isolation_checks_cover_the_banded_and_data_modules():
    """The banded backend, the timing helper, the tile sweep, the OGB
    loader and the on-device prep are among the sources both isolation
    checks read and import."""
    sources = {os.path.relpath(p, REPO) for p in port_sources()}
    for mod in ("ops/banded.py", "utils/timing.py", "scripts/tune_banded.py",
                "data/ogb.py", "prep/device.py", "data/algorithms.py"):
        assert os.path.join("kpgnn_tpu_torch", mod) in sources, mod
    from kpgnn_tpu_torch.ops.banded import BandedAdj
    from kpgnn_tpu_torch.prep.device import device_khop_dense
    assert BandedAdj.__module__ == "kpgnn_tpu_torch.ops.banded"
    assert device_khop_dense.__module__ == "kpgnn_tpu_torch.prep.device"


def test_isolation_checks_cover_the_parallel_modules():
    """The process-group mesh, the data-parallel, node-sharded and
    multi-host steps and the sharded adjacency are among the sources both
    isolation checks read and import."""
    sources = {os.path.relpath(p, REPO) for p in port_sources()}
    for mod in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/dp.py", "parallel/partition.py",
                "parallel/multihost.py", "ops/sharded_adjacency.py"):
        assert os.path.join("kpgnn_tpu_torch", mod) in sources, mod
    from kpgnn_tpu_torch.ops.sharded_adjacency import ShardedCOOAdj
    from kpgnn_tpu_torch.parallel.mesh import Mesh
    assert ShardedCOOAdj.__module__ == "kpgnn_tpu_torch.ops.sharded_adjacency"
    assert Mesh.__module__ == "kpgnn_tpu_torch.parallel.mesh"


def _rank_modules(rank, world):
    """A spawned rank's halo exchange and all-reduce, then the JAX-side
    modules its process holds."""
    import numpy as np
    from kpgnn_tpu_torch.ops.adjacency import COOAdj
    from kpgnn_tpu_torch.ops.sharded_adjacency import (all_reduce_sum,
                                                       halo_exchange)
    from kpgnn_tpu_torch.parallel.mesh import make_mesh
    from kpgnn_tpu_torch.parallel.partition import partition_adj

    mesh = make_mesh(("node",))
    recv = np.arange(8, dtype=np.int32)
    adj = COOAdj(senders=torch.from_numpy((recv + 3) % 8),
                 receivers=torch.from_numpy(recv),
                 edge_attr=torch.ones(8, 1, dtype=torch.int32),
                 edge_mask=torch.ones(8, dtype=torch.bool), n_nodes=8)
    shard = partition_adj(adj, world, rank, mesh.group("node"))
    x = torch.arange(4.0) + 4 * rank
    ext = halo_exchange(shard, x[:, None])
    total = all_reduce_sum(x.sum(), mesh.group("node"))
    return (ext[:, 0].tolist(), float(total),
            sorted(m for m in sys.modules if m.split(".")[0] in BANNED))


def test_spawned_rank_imports_no_jax():
    """Two spawned gloo ranks run the halo exchange and an all-reduce:
    each extended table holds its own rows and the rows its edges read
    from the other rank, and neither process imported JAX or the JAX
    package."""
    from kpgnn_tpu_torch.parallel.mesh import spawn

    out = spawn(_rank_modules, 2, "gloo")
    for rank, (ext, total, banned) in enumerate(out):
        assert banned == [], banned
        assert total == sum(range(8))
        own = [4.0 * rank + i for i in range(4)]
        assert ext[:4] == own
        # rank r's receivers 4r..4r+3 read senders 4r+3..4r+6 (mod 8):
        # the other rank's first three rows
        other = [4.0 * (1 - rank) + i for i in range(3)]
        assert len(ext) == 4 + 2 * 3
        assert ext[4 + 3 * (1 - rank):][:3] == other


def test_isolation_checks_cover_the_tool_scripts():
    """The three tool scripts (the kernel's plan-shape sweep, the scaling
    estimate, the golden-bundle writer) and what they added to convert
    and parity are among the sources both isolation checks read and
    import."""
    sources = {os.path.relpath(p, REPO) for p in port_sources()}
    for mod in ("scripts/tune_pallas.py", "scripts/scaling_estimate.py",
                "scripts/make_parity_golden.py", "utils/convert.py",
                "utils/parity.py"):
        assert os.path.join("kpgnn_tpu_torch", mod) in sources, mod
    from kpgnn_tpu_torch.scripts import make_parity_golden
    from kpgnn_tpu_torch.utils.convert import params_to_flax
    assert params_to_flax.__module__ == "kpgnn_tpu_torch.utils.convert"
    # bundles go under the port, never into the JAX package's goldens
    assert "``kpgnn_tpu_torch/data/parity_golden``" in (
        make_parity_golden.__doc__)


@pytest.mark.parametrize("script,argv", [
    ("tune_pallas", ["--batch_size", "2"]),
    ("scaling_estimate", ["--mode", "ici", "--n_nodes", "256"]),
    ("scaling_estimate", ["--mode", "weak", "--ranks", "1"]),
    ("make_parity_golden", ["--all"])])
def test_tool_scripts_without_cuda_raise(tmp_path, monkeypatch, script,
                                         argv):
    """The default device is cuda: without CUDA each tool script raises
    before it builds, spawns or writes anything; --device cpu runs
    (tests/test_torch_{tune_pallas,scaling_estimate,parity_golden}.py)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import importlib
    mod = importlib.import_module(f"kpgnn_tpu_torch.scripts.{script}")
    monkeypatch.chdir(tmp_path)
    if script == "make_parity_golden":
        argv = argv + ["--out_dir", str(tmp_path / "s")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(argv)
    assert not any(tmp_path.iterdir())
