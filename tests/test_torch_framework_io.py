"""Checkpoints across the packages (paddle_tpu_torch/framework_io.py):
the port's `save` read by the reference's `paddle_tpu.load`, and the
reference's `save` read by the port's `load`, with bfloat16 tensors
(ml_dtypes arrays on the reference's side) bit for bit, f32 and integer
tensors, Python values and nesting; `load` refuses a pickle that names
anything but numpy's arrays; a GPT's state_dict through
`params_to_paddle_tpu` loads in the reference model and back; and the
serving CLI (`python -m paddle_tpu_torch.inference.serve --state-dict`)
serves a bf16 checkpoint that the reference's paddle_tpu.save wrote after
amp.decorate O2: it answers /healthz and /generate with the tokens of the
model `serve.build_model` makes from that file, whose weights are the
checkpoint's bf16 values."""
import json
import os
import pickle
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import amp as jamp
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.models.gpt import PRESETS as JAX_PRESETS

from paddle_tpu_torch import framework_io as fio
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.models import gpt as tgpt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
CLI_S = 60
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _obj():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    return x, {
        "w": torch.from_numpy(x).to(torch.bfloat16),
        "f": torch.from_numpy(x[0].copy()),
        "ids": torch.arange(4),
        "nested": {"list": [torch.ones(2, dtype=torch.bfloat16), 3],
                   "tuple": (1.5, "s")},
        "step": 7,
    }


def test_port_save_reference_load(tmp_path):
    x, obj = _obj()
    path = str(tmp_path / "a" / "port.pdparams")
    fio.save(obj, path)
    got = paddle_tpu.load(path)
    w = np.asarray(got["w"]._data)
    assert w.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(_bits(w), _bits(obj["w"]))
    np.testing.assert_array_equal(np.asarray(got["f"]._data), x[0])
    np.testing.assert_array_equal(np.asarray(got["ids"]._data),
                                  np.arange(4))
    assert np.asarray(got["nested"]["list"][0]._data).dtype == \
        ml_dtypes.bfloat16
    assert got["nested"]["list"][1] == 3
    assert got["nested"]["tuple"] == (1.5, "s") and got["step"] == 7
    # and back through the port's own load
    again = fio.load(path)
    assert again["w"].dtype == torch.bfloat16
    assert torch.equal(again["w"], obj["w"])
    assert torch.equal(again["ids"], obj["ids"])


@pytest.mark.parametrize("protocol", [4, 5])
def test_reference_save_port_load(tmp_path, protocol):
    """Protocol 4 (paddle_tpu.save's default: numpy's `_reconstruct`) and
    5 (numpy's `_frombuffer`)."""
    x, _ = _obj()
    path = str(tmp_path / "ref.pdparams")
    jw = paddle_tpu.cast(paddle_tpu.to_tensor(x), "bfloat16")
    paddle_tpu.save({"w": jw, "f": paddle_tpu.to_tensor(x),
                     "lst": [paddle_tpu.to_tensor(np.arange(3))],
                     "global_step": 2}, path, protocol=protocol)
    got = fio.load(path)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["w"]), _bits(jw._data))
    np.testing.assert_array_equal(got["f"].numpy(), x)
    assert got["lst"][0].tolist() == [0, 1, 2] and got["global_step"] == 2


def test_load_refuses_other_globals(tmp_path):
    evil = tmp_path / "evil.pdparams"
    evil.write_bytes(pickle.dumps({"w": os.system}))
    with pytest.raises(pickle.UnpicklingError, match="only numpy arrays"):
        fio.load(str(evil))
    obj = tmp_path / "obj.pdparams"
    obj.write_bytes(pickle.dumps({"w": np.array([object()], dtype=object)}))
    with pytest.raises(pickle.UnpicklingError):
        fio.load(str(obj))


def test_gpt_state_dict_round_trip(tmp_path):
    """A bf16 port GPT saved in the reference's layout loads into the
    reference's GPT (Linear weights transposed) and back, bit for bit."""
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    tm = tm.to(torch.bfloat16)
    path = str(tmp_path / "gpt.pdparams")
    fio.save(fio.params_to_paddle_tpu(tm.state_dict()), path)
    jm = jamp.decorate(GPTForCausalLM(GPTConfig(**CFG)), level="O2",
                       dtype="bfloat16")
    jm.set_state_dict(paddle_tpu.load(path))
    ref = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    assert ref["gpt.blocks.0.attn.qkv_proj.weight"].shape == (32, 96)
    back = fio.params_from_paddle_tpu(ref)
    for n, t in tm.state_dict().items():
        assert back[n].dtype == torch.bfloat16
        assert torch.equal(back[n], t), n


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with OPENER.open(req, timeout=CLI_S) as r:
        return r.status, json.loads(r.read())


def test_cli_serves_a_bf16_reference_checkpoint(tmp_path):
    paddle_tpu.seed(0)
    jm = jamp.decorate(GPTForCausalLM(JAX_PRESETS["gpt3-tiny"]), level="O2",
                       dtype="bfloat16")
    ckpt = tmp_path / "bf16.pdparams"
    paddle_tpu.save(jm.state_dict(), str(ckpt))
    model = serve.build_model("gpt3-tiny", str(ckpt), "cpu")
    want_sd = fio.params_from_paddle_tpu(
        {n: np.asarray(v._data).astype(np.float32)
         for n, v in jm.state_dict().items()})
    for n, t in model.state_dict().items():
        assert torch.equal(t, want_sd[n]), n
    prompt = list(range(1, 9))
    want = model.generate([prompt], max_new_tokens=6)[0, 8:].tolist()
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
         "--generate", "gpt3-tiny", "--state-dict", str(ckpt), "--http",
         str(port), "--device", "cpu", "--slots", "2"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + CLI_S
        while True:
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            try:
                if _request(url + "/healthz")[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            assert time.monotonic() < deadline, "the CLI did not answer"
            time.sleep(0.2)
        status, body = _request(url + "/generate", {
            "input_ids": prompt, "max_new_tokens": 6})
        assert status == 200 and body["tokens"] == want
    finally:
        proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
