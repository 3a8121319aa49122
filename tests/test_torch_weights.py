"""Weight files in the port (``models/safetensors_io.py``,
``models/pretrained.py``, ``train/checkpoint.py``'s importer and
``inference.load_trained_model``) against the JAX package's, on the CPU.

The JAX variables are drawn from a seed (every leaf random, BatchNorm
statistics included) and carried to the port's names by
``state_dict_from_jax``; files are written by either package and read by
the other. Every comparison is bit for bit.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch
from transformers import BertConfig, BertForMaskedLM

from clip_for_dl_tpu import inference as jinference
from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.core.config import get_preset as jget_preset
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models import pretrained as jpretrained
from clip_for_dl_tpu.models import safetensors_io as jst
from clip_for_dl_tpu.models.torch_export import save_reference_checkpoint
from clip_for_dl_tpu.testing.torch_mirrors import TorchResNet, randomize_bn_stats
from clip_for_dl_tpu.train import CheckpointManager as JCheckpointManager
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import base_transform
from clip_for_dl_tpu_torch.core.config import ModelConfig, get_preset
from clip_for_dl_tpu_torch.inference import load_trained_model
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax
from clip_for_dl_tpu_torch.models import pretrained, safetensors_io
from clip_for_dl_tpu_torch.train import CheckpointManager, TrainState, import_reference_checkpoint
from clip_for_dl_tpu_torch.train.checkpoint import model_state, reference_models

torch.set_num_threads(1)

TINY = dict(
    image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=128,
    text_layers=2, text_heads=2, text_intermediate_dim=256, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8, dropout=0.0,
)


def _fill(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ("scale", "var"):
        v = rng.uniform(0.5, 1.5, shape)
    else:
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(JCXRClip(JModelConfig(**TINY)).init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 12), jnp.int32))
    rng = np.random.default_rng(5)
    return {"params": _fill(shapes["params"], rng),
            "batch_stats": _fill(shapes["batch_stats"], rng)}


def _want(variables):
    return state_dict_from_jax(variables["params"], variables["batch_stats"])


def _equal(got, want, keys):
    """Bit for bit. BatchNorm's step counters are 0-d; the JAX package's
    numpy writer stores a 0-d array with one dimension (np.ascontiguousarray),
    which torch's BatchNorm loads as the same counter, so those compare by
    value."""
    assert keys, "nothing compared"
    for k in keys:
        a, b = got[k], want[k]
        if k.endswith("num_batches_tracked"):
            a, b = a.reshape(-1), b.reshape(-1)
        assert a.dtype == b.dtype and torch.equal(a, b), k


def _port_load(source, **kw):
    cfg = get_preset("zero_shot").replace(model=ModelConfig(**TINY))
    return load_trained_model(source, cfg, torch.float32, device="cpu", **kw)


def _jax_load(source, **kw):
    cfg = jget_preset("zero_shot").replace(model=JModelConfig(**TINY))
    _, jvars = jinference.load_trained_model(source, cfg, jnp.float32, **kw)
    return state_dict_from_jax(jvars["params"], jvars["batch_stats"])


# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 4, generator=g),
        "f16": torch.randn(5, generator=g).half(),
        "bf16": torch.randn(2, 3, 2, generator=g).bfloat16(),
        "f64": torch.randn(2, generator=g).double(),
        "i64": torch.arange(-3, 4),
        "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "u8": torch.arange(250, 256, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.empty(0, 4),
    }


def test_safetensors_round_trips_bit_equal_each_way(tmp_path):
    """The port's writer and reader against each other and against the
    ``safetensors`` package, metadata included."""
    tensors = _tensors()
    meta = {"a": "1", "clip_for_dl_tpu.epoch": "7"}
    ours = safetensors_io.save_safetensors(tensors, str(tmp_path / "ours.safetensors"), meta)
    back, back_meta = safetensors_io.read_safetensors(ours)
    theirs = safetensors.torch.load_file(ours)
    safetensors.torch.save_file(tensors, str(tmp_path / "theirs.safetensors"), metadata=meta)
    from_theirs, their_meta = safetensors_io.read_safetensors(str(tmp_path / "theirs.safetensors"))
    assert back_meta == their_meta == meta
    for k, v in tensors.items():
        for got in (back[k], theirs[k], from_theirs[k]):
            assert got.dtype == v.dtype and got.shape == v.shape and torch.equal(got, v), k
    # the JAX package's numpy writer, read by the port
    arrays = {k: v.numpy() for k, v in tensors.items() if v.dtype != torch.bfloat16}
    jst.save_safetensors(arrays, str(tmp_path / "jax.safetensors"))
    for k, v in safetensors_io.load_state_dict(str(tmp_path / "jax.safetensors")).items():
        np.testing.assert_array_equal(v.numpy(), arrays[k])


def test_load_state_dict_reads_torch_files_and_snapshots(tmp_path):
    tensors = {k: v for k, v in _tensors().items() if k != "scalar"}
    torch.save({**tensors, "note": "not a tensor"}, tmp_path / "w.pth")
    with pytest.warns(UserWarning, match="non-tensor"):
        got = safetensors_io.load_state_dict(str(tmp_path / "w.pth"))
    _equal(got, tensors, list(tensors))
    snap = tmp_path / "snapshot"
    snap.mkdir()
    torch.save(tensors, snap / "pytorch_model.bin")
    _equal(safetensors_io.load_state_dict(str(snap)), tensors, list(tensors))
    safetensors_io.save_safetensors({"x": torch.ones(2)}, str(snap / "model.safetensors"))
    assert list(safetensors_io.load_state_dict(str(snap))) == ["x"]  # preferred file
    torch.save(torch.nn.Linear(2, 2), tmp_path / "module.pth")
    with pytest.raises(ValueError, match="state_dict"):
        safetensors_io.load_state_dict(str(tmp_path / "module.pth"))
    with pytest.raises(FileNotFoundError):
        safetensors_io.load_state_dict(str(tmp_path))


def test_reference_mirror_is_read_by_either_package(tmp_path, variables):
    """JAX's mirror → the port's importer: ``state_dict_from_jax``'s values;
    the port's mirror → JAX's reader: the JAX export, bit for bit; the
    shared adapter, which the reference's file lacks, left out."""
    want = _want(variables)
    jpath = jst.save_reference_checkpoint_safetensors(
        variables, str(tmp_path / "jax.safetensors"), epoch=4, text_layers=TINY["text_layers"])
    out = import_reference_checkpoint(jpath)
    assert out["epoch"] == 4
    assert set(out["state_dict"]) == {k for k in want if not k.startswith("shared_adapter.")}
    _equal(out["state_dict"], want, list(out["state_dict"]))

    ppath = safetensors_io.save_reference_checkpoint_safetensors(
        want, str(tmp_path / "port.safetensors"), epoch=4)
    jmodels, jepoch = jst.load_reference_checkpoint_safetensors(jpath)
    pmodels, pepoch = jst.load_reference_checkpoint_safetensors(ppath)
    assert jepoch == pepoch == 4 and pmodels.keys() == jmodels.keys()
    for module, sd in jmodels.items():
        assert pmodels[module].keys() == sd.keys(), module
        for k, v in sd.items():
            np.testing.assert_array_equal(pmodels[module][k], v, err_msg=f"{module}.{k}")
    assert reference_models(want).keys() == jmodels.keys()


def test_hub_file_is_refused_as_a_checkpoint(tmp_path):
    path = safetensors_io.save_safetensors({"embeddings.word_embeddings.weight": torch.ones(2, 2)},
                                           str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="not a reference-checkpoint-v1"):
        import_reference_checkpoint(path)
    with pytest.raises(ValueError, match="not a reference-checkpoint-v1"):
        jst.load_reference_checkpoint_safetensors(path)


# ---------------------------------------------------------------------------
# tower files (models/pretrained.py)
# ---------------------------------------------------------------------------


def _resnet_file(tmp_path, dtype=torch.float32, layers=(1, 1, 1, 1)):
    torch.manual_seed(11)
    net = TorchResNet(layers, TINY["resnet_width"])
    randomize_bn_stats(net, 3)
    sd = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in net.state_dict().items()}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 256), torch.zeros(10)
    path = str(tmp_path / f"resnet_{layers}_{dtype}.pth".replace(" ", ""))
    torch.save(sd, path)
    return path, sd


def _bert_snapshot(tmp_path, dtype=torch.float32, name="bert"):
    torch.manual_seed(12)
    mlm = BertForMaskedLM(BertConfig(
        vocab_size=64, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=256, max_position_embeddings=32))
    sd = {k: v.to(dtype) if v.is_floating_point() else v for k, v in mlm.state_dict().items()}
    snap = tmp_path / name
    snap.mkdir()
    safetensors_io.save_safetensors(sd, str(snap / "model.safetensors"))
    return str(snap), {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")}


def _fresh():
    return CXRClip(ModelConfig(**TINY))


def test_init_tower_weights_lays_the_files_exactly(tmp_path, variables):
    """A seeded TorchResNet state dict and an HF BertMaskedLM snapshot
    (``bert.`` prefix, MLM head, pooler) land in the towers bit for bit, as
    JAX's ``init_tower_weights`` lands them; the heads keep their weights."""
    rpath, rsd = _resnet_file(tmp_path)
    bpath, bsd = _bert_snapshot(tmp_path)
    model = _fresh()
    heads = {k: v.clone() for k, v in model.state_dict().items() if "tower" not in k}
    pretrained.init_tower_weights(model, image_path=rpath, text_path=bpath)
    got = model.state_dict()
    _equal({k[len("image_tower."):]: v for k, v in got.items() if k.startswith("image_tower.")},
           rsd, [k for k in model.image_tower.state_dict()])
    _equal({k[len("text_tower."):]: v for k, v in got.items() if k.startswith("text_tower.")},
           bsd, [k for k in model.text_tower.state_dict()])
    _equal(got, heads, list(heads))
    jvars = jpretrained.init_tower_weights(jax.tree.map(np.asarray, variables),
                                           JModelConfig(**TINY), image_path=rpath,
                                           text_path=bpath)
    want = state_dict_from_jax(jvars["params"], jvars["batch_stats"])
    _equal(got, want, [k for k in got if "tower" in k and "num_batches_tracked" not in k])


def test_init_tower_weights_refuses_a_wrong_geometry(tmp_path, variables):
    """A missing block (an extra one in the file) and a wrong width both
    raise, as in JAX, before any weight is written."""
    path, _ = _resnet_file(tmp_path, layers=(2, 1, 1, 1))
    model = _fresh()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="unexpected keys"):
        pretrained.init_tower_weights(model, image_path=path)
    with pytest.raises(ValueError, match="missing keys|unexpected keys"):
        jpretrained.init_tower_weights(variables, JModelConfig(**TINY), image_path=path)
    bpath, bsd = _bert_snapshot(tmp_path)
    cut = {k: v for k, v in bsd.items() if "layer.1." not in k}
    safetensors_io.save_safetensors(cut, str(tmp_path / "cut.safetensors"))
    with pytest.raises(ValueError, match="missing keys"):
        pretrained.init_tower_weights(model, text_path=str(tmp_path / "cut.safetensors"))
    wide = dict(bsd, **{"embeddings.word_embeddings.weight": torch.zeros(64, 96)})
    safetensors_io.save_safetensors(wide, str(tmp_path / "wide.safetensors"))
    with pytest.raises(ValueError, match="shape mismatch"):
        pretrained.init_tower_weights(model, text_path=str(tmp_path / "wide.safetensors"))
    _equal(model.state_dict(), before, list(before))


def test_half_precision_files_are_cast_up(tmp_path):
    """An fp16 file cannot lower the model's precision: every tensor lands
    in fp32, equal to the fp16 values."""
    rpath, rsd = _resnet_file(tmp_path, torch.float16)
    bpath, bsd = _bert_snapshot(tmp_path, torch.bfloat16, "bert16")
    model = pretrained.init_tower_weights(_fresh(), image_path=rpath, text_path=bpath)
    for tower, sd in ((model.image_tower, rsd), (model.text_tower, bsd)):
        for k, v in tower.state_dict().items():
            if v.is_floating_point():
                assert v.dtype == torch.float32 and torch.equal(v, sd[k].float()), k


# ---------------------------------------------------------------------------
# load_trained_model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["pth", "safetensors", "towers"])
def test_load_trained_model_equals_jax(tmp_path, variables, source):
    """A reference ``.pth``, a ``.safetensors`` mirror (JAX's, and the
    port's read by JAX) and tower files: the weights they set equal JAX's
    through ``state_dict_from_jax``."""
    if source == "towers":
        rpath, _ = _resnet_file(tmp_path)
        bpath, _ = _bert_snapshot(tmp_path)
        kw = dict(init_image_tower=rpath, init_text_tower=bpath)
        got = _port_load(None, **kw).state_dict()
        want = _jax_load(None, **kw)
        _equal(got, want, [k for k in got if "tower" in k and "num_batches_tracked" not in k])
        return
    if source == "pth":
        path = save_reference_checkpoint(variables, str(tmp_path / "ref.pth"), epoch=2,
                                         text_layers=TINY["text_layers"])
        paths = [path]
    else:
        paths = [jst.save_reference_checkpoint_safetensors(
                     variables, str(tmp_path / "jax.safetensors"), 2, TINY["text_layers"]),
                 safetensors_io.save_reference_checkpoint_safetensors(
                     _want(variables), str(tmp_path / "port.safetensors"), 2)]
    for path in paths:
        got = _port_load(path).state_dict()
        want = _jax_load(path)
        _equal(got, want, [k for k in got if not k.startswith("shared_adapter.")])
        _equal(got, _want(variables), [k for k in got if not k.startswith("shared_adapter.")])


def test_load_trained_model_restores_the_best_epoch(tmp_path, variables):
    """A checkpoint directory whose best epoch holds the seeded weights and
    whose newer, worse epoch other ones: the port reads its own directory
    format, JAX its orbax one, and both give the seeded weights, all of
    them."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    jmgr = JCheckpointManager(str(tmp_path / "orbax"), max_to_keep=2)
    model = _fresh()
    model.load_state_dict(_want(variables))
    mgr.save(0, TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1)),
             metrics={"val_loss": 1.0})
    jmgr.save(0, JTrainState.create(variables, base_transform()), metrics={"val_loss": 1.0})
    worse = _fresh()
    mgr.save(1, TrainState(worse, torch.optim.SGD(worse.parameters(), lr=0.1)),
             metrics={"val_loss": 2.0})
    other = jax.tree.map(lambda v: v + 1.0, variables)
    jmgr.save(1, JTrainState.create(other, base_transform()), metrics={"val_loss": 2.0})
    jmgr.wait()
    jmgr.close()
    got = _port_load(str(tmp_path / "ckpt")).state_dict()
    _equal(got, _want(variables), list(got))
    _equal(got, _jax_load(str(tmp_path / "orbax")), list(got))
    # bf16 serving: the matmul weights cast, the norms kept
    served = load_trained_model(str(tmp_path / "ckpt"),
                                get_preset("zero_shot").replace(model=ModelConfig(**TINY)),
                                device="cpu")
    assert served.image_tower.conv1.weight.dtype == torch.bfloat16
    assert served.image_tower.bn1.weight.dtype == torch.float32
    assert not served.training
    partial = {k: v for k, v in model_state(model).items() if not k.startswith("view_fusion.")}
    cut = _fresh()
    cut.load_state_dict(partial, strict=False)
    mgr2 = CheckpointManager(str(tmp_path / "partial"))
    mgr2.save(0, TrainState(cut, torch.optim.SGD(cut.parameters(), lr=0.1)))
    payload = torch.load(tmp_path / "partial" / "0.pt", weights_only=True)
    payload["model"] = partial
    torch.save(payload, tmp_path / "partial" / "0.pt")
    with pytest.raises(ValueError, match="allow_partial"):
        _port_load(str(tmp_path / "partial"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _port_load(str(tmp_path / "partial"), allow_partial=True).state_dict()
    _equal(got, _want(variables), [k for k in partial])


def test_use_ema_raises_where_jax_raises(tmp_path, variables):
    """No checkpoint, a reference file, an empty directory: ValueError, as
    the JAX function raises at ``inference.py:65, :72, :106`` (JAX run on
    the reference file; each JAX call compiles the model's init)."""
    path = save_reference_checkpoint(variables, str(tmp_path / "ref.pth"),
                                     text_layers=TINY["text_layers"])
    with pytest.raises(ValueError, match="--use-ema"):
        _jax_load(path, use_ema=True)
    for source in (None, path, str(tmp_path / "empty")):
        with pytest.raises(ValueError, match="use_ema"):
            _port_load(source, use_ema=True)


def test_fresh_init_is_seeded():
    a, b, c = (_port_load(None, seed=s).state_dict() for s in (3, 3, 4))
    _equal(a, b, list(a))
    assert not torch.equal(a["text_projector.fc.weight"], c["text_projector.fc.weight"])
