"""The port's training API (paddle_tpu_torch/hapi: Model, its callbacks,
summary and flops; paddle_tpu_torch/metric) against the JAX package's on
the same seeded numpy data and weights. Model.fit on a small MLP over
FakeData (through ToTensor and Normalize) and over an array dataset, and
on a 1-layer tiny BERT (MLM logits, CrossEntropyLoss with ignore_index),
both packages' DataLoaders shuffling from numpy's global stream seeded
alike: every step's loss within 1e-5 relative over 2 epochs in f32;
evaluate's logs and predict's outputs within 1e-5; EarlyStopping,
LRScheduler, ReduceLROnPlateau and ModelCheckpoint with the reference's
histories, learning rates and files; the .pdparams/.pdopt that the
port's Model.save writes loading in the reference's Model.load and the
other way round; summary's and flops' counts equal to the reference's;
each metric's accumulate() within 1e-7 of the reference's."""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import metric as jmetric
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi import flops as jflops
from paddle_tpu.hapi import summary as jsummary
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertForMaskedLM as JBertForMaskedLM
from paddle_tpu.vision import datasets as jdatasets
from paddle_tpu.vision import transforms as JT

import paddle_tpu_torch.io as tio
from paddle_tpu_torch import framework_io, metric, nn, optimizer
from paddle_tpu_torch.hapi import Model, callbacks, flops, summary
from paddle_tpu_torch.models import BertConfig, BertForMaskedLM
from paddle_tpu_torch.vision import datasets as tdatasets
from paddle_tpu_torch.vision import transforms as TT

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
OUT_ATOL = 1e-5
METRIC_ATOL = 1e-7
IN, HID, CLASSES = 12, 16, 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _mlp(m, d_in=IN):
    return m.Sequential(m.Flatten(), m.Linear(d_in, HID), m.ReLU(),
                        m.Linear(HID, CLASSES))


def _pair(d_in=IN, seed=0):
    """The reference's MLP with its own seeded init, and the port's with
    those weights (framework_io: the Linear weights transposed)."""
    paddle.seed(seed)
    jnet = _mlp(jnn, d_in)
    tnet = _mlp(nn, d_in)
    ref = {n: np.asarray(v.numpy()) for n, v in jnet.state_dict().items()}
    tnet.load_state_dict(framework_io.module_state_from_paddle_tpu(tnet,
                                                                   ref))
    return jnet, tnet


def _arrays(n=48, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, IN)).astype(np.float32)
    w = rng.standard_normal((IN, CLASSES)).astype(np.float32)
    return x, (x @ w).argmax(1).astype(np.int64)


def _ds(pkg, x, y):
    class DS(pkg.Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    return DS()


def _prepared(jnet, tnet, jo, to, metrics=True):
    jm, tm = JModel(jnet), Model(tnet)
    jm.prepare(jo, jnn.CrossEntropyLoss(),
               jmetric.Accuracy(topk=(1, 2)) if metrics else None)
    tm.prepare(to, nn.CrossEntropyLoss(),
               metric.Accuracy(topk=(1, 2)) if metrics else None)
    return jm, tm


def _fit_both(jm, tm, jdata, tdata, seed=3, **kw):
    np.random.seed(seed)
    jh = jm.fit(jdata, verbose=0, **kw)
    np.random.seed(seed)
    th = tm.fit(tdata, verbose=0, **kw)
    return jh, th


def test_fit_evaluate_predict_over_fakedata():
    """The reference's own hapi test's shape (tests/test_aux.py) at a
    tiny size: FakeData through ToTensor and Normalize, Adam, 2 epochs."""
    jnet, tnet = _pair(3 * 8 * 8)
    jo = jopt.Adam(1e-2, parameters=jnet.parameters())
    to = optimizer.Adam(1e-2, parameters=tnet.parameters())
    jm, tm = _prepared(jnet, tnet, jo, to)
    tf = lambda T: T.Compose([T.ToTensor(),  # noqa: E731
                              T.Normalize([0.5] * 3, [0.5] * 3)])
    jd = jdatasets.FakeData(64, image_shape=(3, 8, 8), transform=tf(JT))
    td = tdatasets.FakeData(64, image_shape=(3, 8, 8), transform=tf(TT))
    jh, th = _fit_both(jm, tm, jd, td, batch_size=16, epochs=2)
    assert len(th["loss"]) == len(jh["loss"]) == 8
    assert _rel(th["loss"], jh["loss"]) <= LOSS_RTOL
    assert th["loss"][-1] < th["loss"][0]
    jl, tl = jm.evaluate(jd, batch_size=16, verbose=0), \
        tm.evaluate(td, batch_size=16, verbose=0)
    assert tl.keys() == jl.keys() == {"loss", "acc_top1"}
    assert abs(tl["loss"] - jl["loss"]) <= OUT_ATOL
    np.testing.assert_allclose(tl["acc_top1"], jl["acc_top1"], atol=1e-7)
    jp = jm.predict(jd, batch_size=16, stack_outputs=True)
    tp = tm.predict(td, batch_size=16, stack_outputs=True)
    assert tp.shape == (64, CLASSES) and tp.dtype == np.float32
    np.testing.assert_allclose(tp, np.asarray(jp), atol=OUT_ATOL, rtol=0)
    parts = tm.predict(td, batch_size=16)
    assert len(parts) == 4
    np.testing.assert_array_equal(np.concatenate(parts), tp)


@pytest.mark.parametrize("workers", [0, 2])
def test_fit_over_a_dataloader_and_batch_calls(workers):
    x, y = _arrays()
    jnet, tnet = _pair()
    jo = jopt.SGD(0.1, parameters=jnet.parameters())
    to = optimizer.SGD(0.1, parameters=tnet.parameters())
    jm, tm = _prepared(jnet, tnet, jo, to)
    np.random.seed(4)
    jloader = jio.DataLoader(_ds(jio, x, y), batch_size=8, shuffle=True)
    np.random.seed(4)
    jh = jm.fit(jloader, epochs=2, verbose=0)
    np.random.seed(4)
    tloader = tio.DataLoader(_ds(tio, x, y), batch_size=8, shuffle=True,
                             num_workers=workers)
    np.random.seed(4)
    th = tm.fit(tloader, epochs=2, verbose=0)
    assert _rel(th["loss"], jh["loss"]) <= LOSS_RTOL
    assert tm.train_batch(x[:8], y[:8])[0] == pytest.approx(
        jm.train_batch(paddle.to_tensor(x[:8]),
                       paddle.to_tensor(y[:8]))[0], rel=LOSS_RTOL)
    np.testing.assert_allclose(tm.eval_batch(x[:8], y[:8]),
                               jm.eval_batch(x[:8], y[:8]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm.predict_batch(x[:8])[0],
                               jm.predict_batch(x[:8])[0], atol=OUT_ATOL)


def test_fit_over_a_pipeline_and_num_iters():
    x, y = _arrays()
    jnet, tnet = _pair()
    jo = jopt.Momentum(0.05, parameters=jnet.parameters())
    to = optimizer.Momentum(0.05, parameters=tnet.parameters())
    jm, tm = _prepared(jnet, tnet, jo, to, metrics=False)
    from paddle_tpu.io import pipeline as jpipe

    from paddle_tpu_torch.io import pipeline as tpipe

    jp = jpipe.from_dataset(_ds(jio, x, y), shuffle=True, seed=2,
                            shard_rank=0, shard_count=1).batch(8)
    tp = tpipe.from_dataset(_ds(tio, x, y), shuffle=True, seed=2,
                            shard_rank=0, shard_count=1).batch(8) \
        .workers(2).device_prefetch(2, device="cpu")
    jh = jm.fit(jp, epochs=3, num_iters=10, verbose=0)
    th = tm.fit(tp, epochs=3, num_iters=10, verbose=0)
    assert len(th["loss"]) == len(jh["loss"]) == 10
    assert _rel(th["loss"], jh["loss"]) <= LOSS_RTOL


def test_early_stopping_history():
    x, y = _arrays()
    for lr, patience in ((0.0, 0), (0.05, 1)):
        jnet, tnet = _pair()
        jm, tm = _prepared(jnet, tnet,
                           jopt.SGD(lr, parameters=jnet.parameters()),
                           optimizer.SGD(lr, parameters=tnet.parameters()))
        jes, tes = jcb.EarlyStopping(patience=patience), \
            callbacks.EarlyStopping(patience=patience)
        jh = jm.fit(_ds(jio, x, y), batch_size=16, epochs=6, verbose=0,
                    shuffle=False, callbacks=[jes])
        th = tm.fit(_ds(tio, x, y), batch_size=16, epochs=6, verbose=0,
                    shuffle=False, callbacks=[tes])
        assert len(th["loss"]) == len(jh["loss"])
        assert tm.stop_training == jm.stop_training
        assert (tes.wait, tes.best is None) == (jes.wait, jes.best is None)
        assert _rel(th["loss"], jh["loss"]) <= LOSS_RTOL


def test_lr_scheduler_and_reduce_on_plateau():
    x, y = _arrays()
    jnet, tnet = _pair()
    jsched = jopt.lr.StepDecay(0.2, step_size=3, gamma=0.5)
    tsched = optimizer.lr.StepDecay(0.2, step_size=3, gamma=0.5)
    jm, tm = _prepared(jnet, tnet,
                       jopt.SGD(jsched, parameters=jnet.parameters()),
                       optimizer.SGD(tsched, parameters=tnet.parameters()))
    jh = jm.fit(_ds(jio, x, y), batch_size=16, epochs=2, verbose=0,
                shuffle=False, callbacks=[jcb.LRScheduler()])
    th = tm.fit(_ds(tio, x, y), batch_size=16, epochs=2, verbose=0,
                shuffle=False, callbacks=[callbacks.LRScheduler()])
    assert _rel(th["loss"], jh["loss"]) <= LOSS_RTOL
    assert tsched.last_epoch == jsched.last_epoch
    assert tm._optimizer.get_lr() == pytest.approx(jm._optimizer.get_lr())

    jnet, tnet = _pair()
    jm, tm = _prepared(jnet, tnet,
                       jopt.SGD(0.5, parameters=jnet.parameters()),
                       optimizer.SGD(0.5, parameters=tnet.parameters()))
    jr = jcb.ReduceLROnPlateau(patience=1, factor=0.5, min_delta=10.0)
    tr = callbacks.ReduceLROnPlateau(patience=1, factor=0.5, min_delta=10.0)
    jh = jm.fit(_ds(jio, x, y), eval_data=_ds(jio, x, y), batch_size=16,
                epochs=3, verbose=0, shuffle=False, callbacks=[jr])
    th = tm.fit(_ds(tio, x, y), eval_data=_ds(tio, x, y), batch_size=16,
                epochs=3, verbose=0, shuffle=False, callbacks=[tr])
    assert _rel(th["loss"], jh["loss"]) <= LOSS_RTOL
    assert tm._optimizer.get_lr() == jm._optimizer.get_lr() < 0.5
    assert (tr.wait, tr.cooldown_counter) == (jr.wait, jr.cooldown_counter)


def test_model_checkpoint_files(tmp_path):
    x, y = _arrays()
    jnet, tnet = _pair()
    jm, tm = _prepared(jnet, tnet,
                       jopt.Adam(1e-2, parameters=jnet.parameters()),
                       optimizer.Adam(1e-2, parameters=tnet.parameters()))
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    jm.fit(_ds(jio, x, y), batch_size=16, epochs=2, verbose=0,
           shuffle=False, save_dir=str(jdir),
           callbacks=[jcb.ModelCheckpoint(1, str(jdir))])
    tm.fit(_ds(tio, x, y), batch_size=16, epochs=2, verbose=0,
           shuffle=False, save_dir=str(tdir),
           callbacks=[callbacks.ModelCheckpoint(1, str(tdir))])
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
        "epoch0.pdopt", "epoch0.pdparams", "epoch1.pdopt",
        "epoch1.pdparams"]
    for name in ("0.pdparams", "epoch1.pdparams", "epoch1.pdopt"):
        want = paddle.load(str(jdir / name))
        got = paddle.load(str(tdir / name))     # the reference reads it
        # the reference's .pdopt after a compiled fit holds global_step
        # alone (its moments live in the jitted step's state); the port's
        # also holds every parameter's moments, in the reference's layout
        assert set(want) <= set(got)
        if name.endswith(".pdopt"):
            assert {k for k in got if k != "global_step"} == {
                f"p{i}.moment{j}" for i in range(4) for j in (1, 2)}
            assert tuple(got["p0.moment1"].shape) == (IN, HID)
        for k, w in want.items():
            if k == "global_step":
                assert got[k] == w
                continue
            w, g = np.asarray(w.numpy()), np.asarray(got[k].numpy())
            assert g.shape == w.shape, k
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{name}:{k}")


def test_save_and_load_across_the_packages(tmp_path):
    x, y = _arrays()
    jnet, tnet = _pair()
    jm, tm = _prepared(jnet, tnet,
                       jopt.Adam(1e-2, parameters=jnet.parameters()),
                       optimizer.Adam(1e-2, parameters=tnet.parameters()))
    jm.fit(_ds(jio, x, y), batch_size=16, epochs=1, verbose=0,
           shuffle=False)
    tm.fit(_ds(tio, x, y), batch_size=16, epochs=1, verbose=0,
           shuffle=False)
    tm.save(str(tmp_path / "port"))
    jm.save(str(tmp_path / "ref"))
    # the reference's Model reads the port's .pdparams (its load refreshes
    # the network, not a step compiled before it: load, then predict)
    jnet2, _ = _pair(seed=5)
    jm2 = JModel(jnet2)
    jm2.load(str(tmp_path / "port"))
    np.testing.assert_allclose(np.asarray(jm2.predict_batch(x)[0]),
                               tm.predict_batch(x)[0], atol=OUT_ATOL)
    # and the port's .pdopt holds the port's moments in its layout
    opt = paddle.load(str(tmp_path / "port.pdopt"))
    mine = framework_io.transpose_optimizer_state(
        tm._optimizer.state_dict(), tm._param_names(),
        framework_io.linear_weight_names(tnet))
    assert opt.keys() == mine.keys()
    for k, v in mine.items():
        if k != "global_step":
            np.testing.assert_array_equal(np.asarray(opt[k].numpy()),
                                          v.numpy())
    assert opt["global_step"] == 3
    # the port's Model reads the reference's files
    _, tnet3 = _pair(seed=6)
    tm3 = Model(tnet3)
    tm3.prepare(optimizer.Adam(1e-2, parameters=tnet3.parameters()),
                nn.CrossEntropyLoss())
    tm3.load(str(tmp_path / "ref"))
    np.testing.assert_allclose(tm3.predict_batch(x)[0],
                               np.asarray(jm.predict_batch(x)[0]),
                               atol=OUT_ATOL)
    assert tm3._optimizer._global_step == 3
    # a port checkpoint resumes bitwise in the port
    _, tnet4 = _pair(seed=7)
    tm4 = Model(tnet4)
    tm4.prepare(optimizer.Adam(1e-2, parameters=tnet4.parameters()),
                nn.CrossEntropyLoss())
    tm4.load(str(tmp_path / "port"))
    assert tm4.train_batch(x[:16], y[:16]) == tm.train_batch(x[:16],
                                                             y[:16])
    for a, b in zip(tnet4.parameters(), tnet.parameters()):
        assert torch.equal(a, b)


def test_queue5_arguments_raise():
    _, tnet = _pair()
    tm = Model(tnet)
    with pytest.raises(NotImplementedError, match="queue 5"):
        tm.prepare(mesh=object())
    tm.prepare(optimizer.SGD(0.1, parameters=tnet.parameters()),
               nn.CrossEntropyLoss())
    with pytest.raises(NotImplementedError, match="queue 5"):
        tm.fit(_ds(tio, *_arrays()), ckpt_dir="/nonexistent")


def _bert_pair(seed=0):
    widths = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                  intermediate_size=64, max_position=128, dropout=0.0)
    jnet = JBertForMaskedLM(JBertConfig(**widths))
    rng = np.random.default_rng(seed)
    named = {}
    for n, p in jnet.named_parameters():
        v = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        v *= np.float32(0.02 if n.endswith("bias") else 0.05)
        if "norm" in n and n.endswith("weight"):
            v += np.float32(1)
        p.set_value(v)
        named[n] = v
    tnet = BertForMaskedLM(BertConfig(**widths), device="cpu")
    tnet.load_state_dict(framework_io.params_from_paddle_tpu(named))
    return jnet, tnet


def test_fit_tiny_bert_mlm():
    """A 1-layer BERT (hidden 32, 2 heads, L 128: the port's flash path,
    its plain versions on the CPU) trained by Model.fit on MLM batches:
    the logits' CrossEntropyLoss(ignore_index=-100)."""
    rng = np.random.default_rng(7)
    ids = rng.integers(2, 64, (12, 128)).astype(np.int64)
    pos = rng.random(ids.shape) < 0.15
    pos[:, 0] = True
    labels = np.where(pos, ids, -100).astype(np.int64)
    ids = np.where(pos, 1, ids).astype(np.int64)
    jnet, tnet = _bert_pair()
    jm, tm = JModel(jnet), Model(tnet)
    jm.prepare(jopt.AdamW(1e-3, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(ignore_index=-100))
    tm.prepare(optimizer.AdamW(1e-3, parameters=tnet.parameters()),
               nn.CrossEntropyLoss(ignore_index=-100))
    jh, th = _fit_both(jm, tm, _ds(jio, ids, labels), _ds(tio, ids, labels),
                       batch_size=4, epochs=2)
    assert len(th["loss"]) == 6
    assert _rel(th["loss"], jh["loss"]) <= LOSS_RTOL
    jl = jm.evaluate(_ds(jio, ids, labels), batch_size=4, verbose=0)
    tl = tm.evaluate(_ds(tio, ids, labels), batch_size=4, verbose=0)
    assert abs(tl["loss"] - jl["loss"]) <= OUT_ATOL * abs(jl["loss"])
    tp = tm.predict(_ds(tio, ids, labels), batch_size=4,
                    stack_outputs=True)
    jp = np.asarray(jm.predict(_ds(jio, ids, labels), batch_size=4,
                               stack_outputs=True))
    assert tp.shape == (12, 128, 64)
    np.testing.assert_allclose(tp, jp, atol=OUT_ATOL, rtol=0)


def test_amp_configs_run_the_step_under_auto_cast():
    """prepare(amp_configs=O2) on an amp.decorate'd model: fit's loss is
    the loss of the same forward under amp.auto_cast (the bf16 logits'
    cross-entropy in f32), not the bf16 one."""
    from paddle_tpu_torch import amp

    rng = np.random.default_rng(8)
    ids = rng.integers(2, 64, (4, 128)).astype(np.int64)
    labels = np.where(rng.random(ids.shape) < 0.15, ids, -100)
    _, tnet = _bert_pair()
    tnet = amp.decorate(tnet, level="O2", dtype="bfloat16")
    loss = nn.CrossEntropyLoss(ignore_index=-100)
    with torch.no_grad(), amp.auto_cast(dtype="bfloat16"):
        want = float(loss(tnet(torch.from_numpy(ids)),
                          torch.from_numpy(labels)))
    with torch.no_grad():
        plain = float(loss(tnet(torch.from_numpy(ids)),
                           torch.from_numpy(labels)))
    tm = Model(tnet)
    tm.prepare(optimizer.AdamW(1e-3, parameters=tnet.parameters(),
                               multi_precision=True), loss,
               amp_configs={"level": "O2", "dtype": "bfloat16"})
    got = tm.fit(_ds(tio, ids, labels), batch_size=4, epochs=1, verbose=0,
                 shuffle=False)["loss"][0]
    assert got == want != plain
    assert tm.evaluate(_ds(tio, ids, labels), batch_size=4,
                       verbose=0)["loss"] < got


def test_summary_and_flops_counts():
    jnet, tnet = _pair()
    assert summary(tnet) == jsummary(jnet)
    assert Model(tnet).summary() == jsummary(jnet)
    conv_j = jnn.Sequential(jnn.Conv2D(3, 8, 3, padding=1),
                            jnn.BatchNorm2D(8), jnn.ReLU(), jnn.Flatten(),
                            jnn.Linear(8 * 6 * 6, 10), jnn.LayerNorm(10))
    conv_t = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8),
                           nn.ReLU(), nn.Flatten(), nn.Linear(8 * 6 * 6, 10),
                           nn.LayerNorm(10))
    assert flops(conv_t, [2, 3, 6, 6]) == jflops(conv_j, [2, 3, 6, 6]) > 0
    assert flops(tnet, [4, IN]) == jflops(jnet, [4, IN])
    assert summary(conv_t) == jsummary(conv_j)


@pytest.mark.parametrize("topk", [(1,), (1, 3), 2])
def test_accuracy(topk):
    rng = np.random.default_rng(1)
    got, want = metric.Accuracy(topk=topk), jmetric.Accuracy(topk=topk)
    for _ in range(3):
        p = rng.standard_normal((10, 6)).astype(np.float32)
        lab = rng.integers(0, 6, (10, 1))
        want.update(want.compute(paddle.to_tensor(p),
                                 paddle.to_tensor(lab)))
        got.update(got.compute(torch.from_numpy(p), torch.from_numpy(lab)))
    np.testing.assert_allclose(got.accumulate(), want.accumulate(),
                               atol=METRIC_ATOL)
    assert got.name() == want.name()
    np.testing.assert_allclose(
        float(metric.accuracy(torch.from_numpy(p), torch.from_numpy(lab),
                              k=2)),
        float(np.asarray(jmetric.accuracy(paddle.to_tensor(p),
                                          paddle.to_tensor(lab),
                                          k=2).numpy())),
        atol=METRIC_ATOL)


@pytest.mark.parametrize("kind", ["precision", "recall", "auc", "auc2d"])
def test_binary_metrics(kind):
    rng = np.random.default_rng(2)
    make = {"precision": lambda m: m.Precision(),
            "recall": lambda m: m.Recall(),
            "auc": lambda m: m.Auc(num_thresholds=255),
            "auc2d": lambda m: m.Auc()}[kind]
    got, want = make(metric), make(jmetric)
    for _ in range(4):
        p = rng.random((16, 2) if kind == "auc2d" else 16).astype(np.float32)
        lab = rng.integers(0, 2, 16)
        want.update(paddle.to_tensor(p), paddle.to_tensor(lab))
        got.update(torch.from_numpy(p), torch.from_numpy(lab))
    np.testing.assert_allclose(got.accumulate(), want.accumulate(),
                               atol=METRIC_ATOL)
    assert got.name() == want.name()
    got.reset()
    assert got.accumulate() == 0.0 or kind in ("precision", "recall")
