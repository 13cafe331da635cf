"""The port stands alone: no module of src/repro_torch/ and not
chip_smoke.py imports jax, the JAX package ``repro`` or ``msgpack`` (the
GPU machine has neither jax nor msgpack); every module imports with them
blocked; entry points and every function that makes
tensors from host values default to the GPU and refuse to fall back to
the CPU, but for the dry run, which runs on ``meta`` with no card; the port's float32 wire frames are byte-identical to the
reference codec's."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = _imports(path) & {"jax", "jaxlib", "repro", "msgpack"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', "
        "'msgpack'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro', 'msgpack') "
        "for k in sys.modules)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_default_device_refuses_a_gpu_less_host(monkeypatch):
    import torch
    from repro_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.default_device()
    from repro_torch.launch import fed_dryrun, fed_serve, fed_train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_train.main(["--clients", "2", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_train.main(["--clients", "2", "--rounds", "1", "--mesh",
                        "clients:2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_dryrun.main(["--clients", "100", "--active", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_serve.main(["--clients", "2", "--ckpt-dir", "unused"])


def test_dryrun_needs_no_card(monkeypatch, capsys):
    """The one entry point that runs without a card, as the reference's
    dry run runs without a TPU: it prices a world of devices from
    ``meta`` trees, and every leaf it builds stays there."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import dryrun, steps

    def no_cuda():
        raise AssertionError("the dry run initialized CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    built = []
    real = steps.input_specs
    monkeypatch.setattr(steps, "input_specs",
                        lambda *a, **k: built.append(real(*a, **k))
                        or built[-1])
    [r] = dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k"])
    assert r["memory"]["argument_bytes"] > 0
    [ins] = built
    leaves = tree.leaves({k: v for k, v in ins.items() if k != "window"},
                         is_leaf=steps.is_abstract)
    assert leaves and all(a.value.device.type == "meta" for a in leaves)


def _host_value_makers(tmp_path):
    from repro_torch import convert
    from repro_torch import random as tr
    from repro_torch.data import partition, synthetic
    from repro_torch.data.ingest import mirror, registry
    from repro_torch.fl.runtime import RuntimeConfig
    from repro_torch.fl.runtime.scheduler import arrival_participation
    from repro_torch.fl.transport.worker import (runtime_config_to_dict,
                                                 worker_from_spec)
    from repro_torch.launch import fed_dryrun, fed_train
    from repro_torch.launch import mesh
    from repro_torch.configs import registry as archs
    from repro_torch.data import loader
    from repro_torch.launch import serve, train
    from repro_torch.examples import (federated_training, multiarch_train,
                                      quickstart, serve_decode)
    from repro_torch.models import config as mcfg
    from repro_torch.models import transformer
    cfg = mcfg.reduced(archs.get("yi-6b"))
    x, y, _ = synthetic.make_dataset("synthmnist", 50, tr.PRNGKey(0, "cpu"),
                                     side=12)
    return {
        "PRNGKey": lambda: tr.PRNGKey(0),
        "partition": lambda: partition.partition(
            x.numpy(), y.numpy(), 10, n_clients=2, experiment=1,
            key=tr.PRNGKey(1), n_train=2, n_test=2, n_conf=2),
        "make_dataset": lambda: synthetic.make_dataset(
            "synthmnist", 50, tr.PRNGKey(0), side=12),
        "registry.load": lambda: registry.load("synthmnist", n_samples=50),
        "registry.load_mirror": lambda: registry.load(
            "mnist", tmp_path, n_samples=50),
        "write_idx_mirror": lambda: mirror.write_idx_mirror(
            tmp_path, "synthmnist", 50, 12, 0),
        "write_leaf_mirror": lambda: mirror.write_leaf_mirror(
            tmp_path, "synthfemnist", 50, 8, 0, n_writers=4),
        "registry.load_leaf": lambda: registry.load(
            "femnist", tmp_path, n_samples=50, n_writers=4),
        "registry.load_stream": lambda: registry.load_stream(
            "synthfemnist", tmp_path, n_samples=50, n_writers=4),
        "build_scenario": lambda: fed_train.build_scenario(
            dataset="synthmnist", clients=2),
        "key_from_numpy": lambda: convert.key_from_numpy([0, 1]),
        "tm_params_from_numpy": lambda: convert.tm_params_from_numpy(
            np.ones((1, 2, 3, 4)), np.ones((1, 2, 3))),
        "engine_state_from_numpy": lambda: convert.engine_state_from_numpy(
            0, np.ones((1, 2, 3, 4)), np.ones((1, 2, 3)), np.zeros((2, 3))),
        "mlp_params_from_numpy": lambda: convert.mlp_params_from_numpy(
            {k: np.ones((2, 3)) for k in ("w1", "b1", "w2", "b2")}),
        "flis_client_state_from_numpy":
            lambda: convert.flis_client_state_from_numpy(
                {k: np.ones((2, 3)) for k in ("w1", "b1", "w2", "b2")},
                np.zeros(2)),
        "server_state_from_numpy": lambda: convert.server_state_from_numpy(
            np.zeros((2, 3)), (np.zeros((4, 3)), np.zeros(2))),
        "arrival_participation": lambda: arrival_participation([1], [0]),
        "worker_from_spec": lambda: worker_from_spec({
            "runtime": runtime_config_to_dict(RuntimeConfig(
                transport="socket", workers=1)),
            "scenario": {"dataset": "synthmnist", "clients": 2,
                         "device": "cuda"}, "key": [0, 0]}, 0),
        "fed_dryrun.client_scale": lambda: fed_dryrun.client_scale(
            100, 2, root=str(tmp_path / "store")),
        "mesh.spawn": lambda: mesh.spawn(mesh.run_federations, 2, []),
        "transformer.init": lambda: transformer.init(tr.PRNGKey(0), cfg),
        "transformer.init_cache": lambda: transformer.init_cache(cfg, 1, 4),
        "TokenBatcher": lambda: loader.TokenBatcher(cfg, 1, 4)(0),
        "FederatedSampler": lambda: loader.FederatedSampler(8, 2).batches(
            0, 0, 0),
        "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
            {"w": [np.ones((2, 3), np.float32)]}),
        "adamw_state_from_numpy": lambda: convert.adamw_state_from_numpy(
            0, {"w": np.zeros(2)}, {"w": np.zeros(2)}),
        "train.main": lambda: train.main(
            ["--arch", "yi-6b", "--reduced", "--steps", "1",
             "--save", str(tmp_path / "ck.msgpack")]),
        "serve.main": lambda: serve.main(["--arch", "yi-6b", "--reduced"]),
        "examples.quickstart": lambda: quickstart.main([]),
        "examples.federated_training": lambda: federated_training.main(
            ["--rounds", "1", "--clients", "2"]),
        "examples.multiarch_train": lambda: multiarch_train.main(
            ["--steps", "1"]),
        "examples.serve_decode": lambda: serve_decode.main([]),
    }


@pytest.mark.parametrize("name", [
    "PRNGKey", "partition", "make_dataset", "registry.load",
    "registry.load_mirror", "write_idx_mirror", "write_leaf_mirror",
    "registry.load_leaf", "registry.load_stream", "build_scenario",
    "key_from_numpy", "tm_params_from_numpy", "engine_state_from_numpy",
    "mlp_params_from_numpy", "flis_client_state_from_numpy",
    "server_state_from_numpy", "arrival_participation",
    "worker_from_spec", "fed_dryrun.client_scale", "mesh.spawn",
    "transformer.init", "transformer.init_cache", "TokenBatcher",
    "FederatedSampler", "lm_params_from_numpy", "adamw_state_from_numpy",
    "train.main", "serve.main", "examples.quickstart",
    "examples.federated_training", "examples.multiarch_train",
    "examples.serve_decode"])
def test_tensors_from_host_values_default_to_the_gpu(monkeypatch, tmp_path,
                                                     name):
    """The partition draws on its key's device, so a GPU default for the
    key (``PRNGKey``) is the partition's too."""
    import torch
    make = _host_value_makers(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert not any(tmp_path.iterdir())   # nothing written before refusing


def test_codec_copy_is_byte_identical():
    """The port meters and decodes the very frames the reference codec
    writes for the float32 wire (every other codec:
    tests/test_torch_codec.py)."""
    from repro.fl.runtime import codec as jcodec
    from repro_torch.fl.runtime import codec
    rng = np.random.default_rng(0)
    for vec in (np.zeros(0, np.float32), rng.normal(size=7),
                rng.integers(0, 9, 300).astype(np.float32),
                np.array([np.inf, -0.0, 1e-45, np.nan], np.float32)):
        frame = codec.encode(vec, codec.CodecConfig())
        assert frame == jcodec.encode(vec, jcodec.CodecConfig())
        back = codec.decode(frame, len(vec), codec.CodecConfig())
        want = jcodec.decode(frame, len(vec), jcodec.CodecConfig())
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back.view(np.int32),
                                      want.view(np.int32))


def test_codec_is_the_references_numpy_code():
    """Below its docstring the port's codec is the reference module's
    code, line for line: every float step is the same numpy operation."""
    def body(path):
        tree = ast.parse(path.read_text())
        return [ast.dump(node) for node in tree.body[1:]]
    ref = ROOT / "src" / "repro" / "fl" / "runtime" / "codec.py"
    assert body(PKG / "fl" / "runtime" / "codec.py") == body(ref)
