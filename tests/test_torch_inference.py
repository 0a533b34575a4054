"""The deployment path of the port (paddle_tpu_torch.jit.save/load, the
inference package's Predictor) against the reference's on the CPU.

The same seeded numpy weights and inputs go through the reference's
jit.save -> Predictor and the port's: an MLP (Linear(8, 16), GELU,
Linear(16, 4)) within 1e-5 absolute, a 2-layer GPT (hidden 128, 4 heads,
seq 128) within LOGIT_ATOL 1e-4. The reference's GPT exports only with
static shapes (its reshapes need concrete dims, and the flash gate's
L % 128 cannot be decided on a symbolic length), so the GPT is saved at
[2, 128] on both sides; the port's also with a dynamic batch, which its
predict engine needs. The port's exported GPT program holds the flash
forward op (its plain CPU kernel runs here; the reference's GPT takes
its einsum path off the TPU). Within the port, the Predictor's
outputs equal the eager module's bitwise, in this process and in a fresh
one that imports only paddle_tpu_torch.inference (and no jax). The
metadata and the pickled parameters are held against the reference's
files; the metadata adds one key, `device`.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu import jit as jjit
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import Predictor as JPredictor
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.static import InputSpec as JInputSpec

from paddle_tpu_torch import jit
from paddle_tpu_torch.framework_io import load as load_state
from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.inference import (Config, Predictor, config_for,
                                        create_predictor,
                                        load_inference_model,
                                        save_inference_model)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.static import InputSpec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_ATOL = 1e-5
LOGIT_ATOL = 1e-4       # logits are O(1); f32 sums in other orders
VOCAB, SEQ = 256, 128
FLASH_OP = "paddle_tpu_torch.flash_fwd.default"


def mlp_weights(seed=0):
    """[in, out] weights and biases of Linear(8, 16) and Linear(16, 4)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((i, o)).astype(np.float32) * 0.3,
             rng.standard_normal(o).astype(np.float32) * 0.1)
            for i, o in ((8, 16), (16, 4))]


def reference_mlp(weights):
    m = jnn.Sequential(jnn.Linear(8, 16), jnn.GELU(), jnn.Linear(16, 4))
    for layer, (w, b) in zip((m[0], m[2]), weights):
        layer.weight.set_value(w)
        layer.bias.set_value(b)
    m.eval()
    return m


def port_mlp(weights):
    """torch's Linear stores [out, in]: the reference's weights
    transposed."""
    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.GELU(),
                            torch.nn.Linear(16, 4))
    with torch.no_grad():
        for layer, (w, b) in zip((m[0], m[2]), weights):
            layer.weight.copy_(torch.from_numpy(w.T))
            layer.bias.copy_(torch.from_numpy(b))
    return m.eval()


def mlp_params_from_reference(named):
    """The reference MLP's {name: [in, out] array} in the port's layout."""
    return {n: (a.T if n.endswith("weight") else a) for n, a in named.items()}


def gpt_pair(seed=0):
    """(reference GPT, port GPT) with the same numpy-drawn parameters."""
    cfg = JGPTConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2,
                     num_heads=4, max_seq_len=SEQ)
    jm = JGPT(cfg)
    jm.eval()
    rng = np.random.default_rng(seed)
    for n, p in jm.named_parameters():
        x = rng.standard_normal(p.shape).astype(np.float32)
        if n.endswith("bias"):
            x *= np.float32(0.02)
        elif ".ln" in n:
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.05)
        p.set_value(x)
    tcfg = tgpt.GPTConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2,
                          num_heads=4, max_seq_len=SEQ)
    tm = tgpt.GPTForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {n: p.numpy() for n, p in jm.named_parameters()}))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def mlp_saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("mlp")
    weights = mlp_weights()
    jm, tm = reference_mlp(weights), port_mlp(weights)
    jjit.save(jm, str(d / "ref"), input_spec=[JInputSpec([None, 8],
                                                         "float32")])
    jit.save(tm, str(d / "port"), input_spec=[InputSpec([None, 8],
                                                        "float32")],
             device="cpu")
    return str(d / "ref"), str(d / "port"), jm, tm


@pytest.fixture(scope="module")
def gpt_saved(tmp_path_factory):
    """Both packages' GPT at [2, SEQ], and the port's at [None, SEQ]."""
    d = tmp_path_factory.mktemp("gpt")
    jm, tm = gpt_pair()
    jjit.save(jm, str(d / "ref"), input_spec=[JInputSpec([2, SEQ],
                                                         "int64")])
    jit.save(tm, str(d / "port"), input_spec=[InputSpec([2, SEQ],
                                                        "int64")])
    jit.save(tm, str(d / "dyn"), input_spec=[InputSpec([None, SEQ],
                                                       "int64")])
    return str(d / "ref"), str(d / "port"), jm, tm, str(d / "dyn")


def _ids(batch, seed=1):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (batch, SEQ)).astype(np.int64)


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_mlp_across_packages_and_bitwise_eager(mlp_saved, batch):
    ref, port, _, tm = mlp_saved
    x = np.random.default_rng(batch).standard_normal(
        (batch, 8)).astype(np.float32)
    (want,) = JPredictor(JConfig(ref)).run([x])
    (got,) = Predictor(config_for(port, "cpu")).run([x])
    assert got.dtype == np.float32 and got.shape == (batch, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=MLP_ATOL)
    with torch.no_grad():
        eager = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, eager)


def test_gpt_across_packages_and_bitwise_eager(gpt_saved):
    ref, port, _, tm, dyn = gpt_saved
    ids = _ids(2)
    (want,) = JPredictor(JConfig(ref)).run([ids])
    with torch.no_grad():
        eager = tm(torch.from_numpy(ids)).numpy()
    for prefix in (port, dyn):
        pred = Predictor(config_for(prefix, "cpu"))
        (got,) = pred.run([ids])
        assert got.shape == (2, SEQ, VOCAB)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_array_equal(got, eager)
        # the exported program calls the flash forward op, once a layer
        ops = [str(n.target) for n in pred._exported.graph.nodes
               if n.op == "call_function"]
        assert ops.count(FLASH_OP) == 2
    # the dynamic batch: another batch size, the same program
    (one,) = pred.run([ids[:1]])
    np.testing.assert_array_equal(one, got[:1])


def test_meta_and_params_match_the_reference_files(mlp_saved, gpt_saved):
    for ref, port, convert in ((*mlp_saved[:2], mlp_params_from_reference),
                               (*gpt_saved[:2], params_from_paddle_tpu)):
        jmeta = json.load(open(ref + ".meta.json"))
        meta = json.load(open(port + ".meta.json"))
        assert set(meta) - set(jmeta) == {"device"}
        assert set(jmeta) <= set(meta)
        for key in ("input_names", "output_names", "input_specs",
                    "format_version"):
            assert meta[key] == jmeta[key], key
        assert meta["device"] == "cpu"
        with open(ref + ".pdiparams", "rb") as f:
            jparams = pickle.load(f)
        want = convert({n: a for n, a in jparams.items()
                        if not n.startswith("__buffer__.")})
        got = load_state(port + ".pdiparams")
        assert set(got) == set(want)
        for n in got:
            np.testing.assert_array_equal(np.asarray(got[n]),
                                          np.asarray(want[n]), err_msg=n)
        # jit.save also writes the state_dict
        assert set(load_state(port + ".pdparams")) == set(got)


class _TwoHeads(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.la = torch.nn.Linear(6, 3)
        self.lb = torch.nn.Linear(3, 2)

    def forward(self, a, b):
        return self.la(a), self.lb(b)


class _RowSum(torch.nn.Module):
    def forward(self, x):
        return x.sum(dim=1)


def test_two_dynamic_axes_export_and_run(tmp_path):
    """Dynamic axes of several inputs, and two in one input, are Dims of
    one export; each resolves on its own at run time."""
    torch.manual_seed(0)
    m = _TwoHeads().eval()
    prefix = str(tmp_path / "two_heads")
    save_inference_model(prefix, m, [InputSpec([None, 6]),
                                     InputSpec([-1, 3])],
                         input_names=["a", "b"], output_names=["oa", "ob"],
                         device="cpu")
    pred, names, outs = load_inference_model(prefix, device="cpu")
    assert (names, outs) == (["a", "b"], ["oa", "ob"])
    meta = json.load(open(prefix + ".meta.json"))
    assert [s["shape"] for s in meta["input_specs"]] == [[None, 6],
                                                         [None, 3]]
    for ra, rb in ((2, 5), (7, 1)):
        a = np.random.default_rng(ra).standard_normal((ra, 6)) \
            .astype(np.float32)
        b = np.random.default_rng(rb).standard_normal((rb, 3)) \
            .astype(np.float32)
        oa, ob = pred.run([a, b])
        with torch.no_grad():
            wa, wb = m(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(oa, wa.numpy())
        np.testing.assert_array_equal(ob, wb.numpy())
    rows = str(tmp_path / "rowsum")
    jit.save(_RowSum(), rows, input_spec=[InputSpec([None, None])],
             device="cpu")
    assert json.load(open(rows + ".meta.json"))["input_specs"] == [
        {"shape": [None, None], "dtype": "float32"}]
    pred = create_predictor(config_for(rows, "cpu"))
    for shape in ((3, 4), (2, 7)):
        x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        (out,) = pred.run([x])
        np.testing.assert_array_equal(out, x.sum(axis=1))


def test_a_symbolic_length_on_the_gpt_is_refused_by_both(tmp_path):
    """The flash gate needs L % 128 == 0, which neither export can decide
    on a symbolic length: both packages refuse [None, None] on a GPT."""
    jm, tm = gpt_pair()
    with pytest.raises(Exception, match="[Ss]ymbolic dimension"):
        jjit.save(jm, str(tmp_path / "ref"),
                  input_spec=[JInputSpec([None, None], "int64")])
    with pytest.raises(Exception, match="d1"):
        jit.save(tm, str(tmp_path / "port"),
                 input_spec=[InputSpec([None, None], "int64")])


def test_handles_devices_and_translated_layer(mlp_saved, tmp_path,
                                              monkeypatch):
    _, port, _, tm = mlp_saved
    x = np.random.default_rng(7).standard_normal((2, 8)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    cfg = Config(port + ".pdmodel")
    cfg.disable_gpu()
    pred = Predictor(cfg)
    assert cfg.prog_file() == port + ".pdmodel"
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(x)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(out, want)
    # a program runs only on the device type it was exported on
    cfg = Config(port)
    cfg.enable_use_gpu(100, 0)
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        Predictor(cfg)
    # the default is the card, which this host lacks: no quiet CPU run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(Config(port))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jit.load(port)
    layer = jit.load(port, device="cpu")
    got = layer(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    assert layer.eval() is layer
    with pytest.raises(RuntimeError, match="inference-only"):
        layer.train()
    # without a program, jit.load gives the state_dict back
    jit.save(tm, str(tmp_path / "state"))
    assert not os.path.exists(str(tmp_path / "state.pdmodel"))
    sd = jit.load(str(tmp_path / "state"))
    assert set(sd) == set(tm.state_dict())
    assert torch.equal(sd["0.weight"], tm.state_dict()["0.weight"])
    assert InputSpec is jit.InputSpec


def test_fresh_process_loads_with_only_the_inference_package(gpt_saved,
                                                             tmp_path):
    """A fresh interpreter imports paddle_tpu_torch.inference alone (no
    model code, no jax), loads the GPT's program and gives the eager
    model's logits bitwise."""
    _, _, _, tm, port = gpt_saved
    ids = _ids(3, seed=5)
    np.save(str(tmp_path / "ids.npy"), ids)
    script = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from paddle_tpu_torch.inference import Predictor, config_for\n"
        f"pred = Predictor(config_for({port!r}, 'cpu'))\n"
        f"(out,) = pred.run([np.load({str(tmp_path / 'ids.npy')!r})])\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'paddle_tpu'))\n"
        "print(' '.join(bad))\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == ""
    with torch.no_grad():
        want = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.load(str(tmp_path / "out.npy")), want)
