"""The port's CLIs and serving plane on the DL baselines against the JAX
package on the CPU.

* ``fed_train --strategy <baseline>`` prints the reference CLI's round,
  totals and decile lines from the same flags (the mean accuracy within
  1e-6, queue C item 3);
* ``fed_serve --strategy <baseline> --verify-offline`` serves with 0
  mismatches;
* the port's plane on a JAX-trained FLIS checkpoint (a dict inside the
  client state's named tuple) returns the JAX plane's predictions."""
import re

import jax
import numpy as np
import pytest

from repro.fl.runtime import Engine as JEngine
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime import checkpointing as jcheckpointing
from repro.fl.runtime.strategy import \
    build_baseline_strategy as jbuild_baseline_strategy
from repro.fl.serve import ModelRegistry as JModelRegistry
from repro.fl.serve import ServingPlane as JServingPlane
from repro.launch import fed_train as jfed_train
from repro_torch import random as tr
from repro_torch.fl.runtime import (Engine, RuntimeConfig,
                                    build_baseline_strategy)
from repro_torch.fl.serve import ModelRegistry, ServingPlane
from repro_torch.launch import fed_serve, fed_train
from test_torch_baselines_loops import ENGINE_KW, _tkey, populations  # noqa: F401
from test_torch_gpu import one_torch_thread  # noqa: F401


def _report_lines(text: str) -> list[str]:
    keep = ("round ", "totals:", "final per-client")
    return [re.sub(r" acc=\S+", "", line) for line in text.splitlines()
            if line.startswith(keep)]


@pytest.mark.parametrize("flags", [
    ["--strategy", "fedavg"],
    ["--strategy", "fedprox", "--active", "4", "--dropout", "0.2"],
    ["--strategy", "ifca"],
    ["--strategy", "flis_dc", "--probe-size", "32"],
    ["--strategy", "flis_hc", "--max-slots", "3", "--active", "4",
     "--dropout", "0.2"]], ids=lambda f: f[1])
def test_fed_train_cli_prints_the_reference_lines(flags, capsys):
    """The two CLIs, given the same flags, print the same round, totals
    and decile lines; the mean accuracy within 1e-6."""
    flags = ["--clients", "6", "--rounds", "2", "--local-epochs", "1",
             *flags]
    ours = fed_train.main(["--device", "cpu", *flags])
    port_text = capsys.readouterr().out
    ref = jfed_train.main(flags)
    ref_text = capsys.readouterr().out
    assert port_text.startswith(f"{flags[7]} on synthmnist")
    assert _report_lines(port_text) == _report_lines(ref_text)
    assert len(_report_lines(port_text)) == 2 + 2
    np.testing.assert_allclose(ours["acc_per_round"], ref["acc_per_round"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["ifca", "flis_hc"])
def test_fed_serve_verifies_a_baseline_offline(tmp_path, capsys, name):
    flags = ["--device", "cpu", "--clients", "4", "--local-epochs", "1",
             "--strategy", name, "--max-slots", "3"]
    fed_train.main(flags + ["--rounds", "2", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "2"])
    out = fed_serve.main(flags + ["--ckpt-dir", str(tmp_path), "--batch",
                                  "8", "--requests", "2",
                                  "--verify-offline"])
    text = capsys.readouterr().out
    assert f"serving {name} version 2" in text
    assert "offline parity: OK (4 clients" in text
    assert out["verified_clients"] == 4 and out["mismatches"] == 0


def test_port_plane_serves_a_jax_flis_checkpoint_as_the_jax_plane(
        populations, tmp_path):
    """A JAX-trained FLIS population (a dict inside the client state's
    named tuple), published into both packages' registries: the port's
    plane returns the JAX plane's predictions for a mixed batch."""
    jdata, data = populations
    kw = ENGINE_KW
    jeng = JEngine(jbuild_baseline_strategy("flis_dc", **kw), jdata,
                   JRuntimeConfig(rounds=2, checkpoint_dir=str(tmp_path / "c"),
                                  checkpoint_every=2))
    jeng.run(jax.random.PRNGKey(0))
    src = jcheckpointing.latest(tmp_path / "c")
    jreg = JModelRegistry(tmp_path / "jreg")
    jreg.publish(src)
    jplane = JServingPlane(jeng.strategy, jreg, jeng.init(
        jax.random.split(jax.random.PRNGKey(0))[0]))
    jplane.refresh()
    reg = ModelRegistry(tmp_path / "treg")
    reg.publish(src)
    teng = Engine(build_baseline_strategy("flis_dc", **kw), data,
                  RuntimeConfig())
    plane = ServingPlane(teng.strategy, reg, teng.init(tr.split(_tkey(0))[0]))
    plane.refresh()
    ids = np.array([0, 3, 1, 4, 2, 2, 0])
    x = np.asarray(jdata.x_test)[ids, np.arange(len(ids))]
    np.testing.assert_array_equal(plane.predict(ids, x),
                                  np.asarray(jplane.predict(ids, x)))
