"""The accounting of ``tools/profile_paths.py`` on synthetic device traces,
and the input makers of ``tools/main_paths.py`` at a tiny size (the
profiles themselves run on the card)."""

import numpy as np
import pytest
import torch

from clip_for_dl_tpu_torch.core.config import get_preset
from clip_for_dl_tpu_torch.tools import main_paths
from clip_for_dl_tpu_torch.tools.profile_paths import TOL, account, bucket_of, union_us


@pytest.mark.parametrize("name, bucket", [
    ("void (anonymous namespace)::flash_fwd_kernel<64>(...)", "B3/B5 attention forward"),
    ("void (anonymous namespace)::flash_bwd_rows_kernel<64>(...)", "B6/B7 attention backward"),
    ("void (anonymous namespace)::flash_fwd_sliced_kernel(...)", "B3/B5 attention forward"),
    ("void (anonymous namespace)::mlp_bwd_gelu_kernel(CUtensorMap_st, CUtensorMap_st, ...)",
     "B8 MLP backward"),
    ("void (anonymous namespace)::mlp_bwd_dx_kernel(CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16*, int, int, int)", "B8 MLP backward"),
    ("void (anonymous namespace)::mlp_fwd_gelu_kernel<(anonymous namespace)::DenseGelu>"
     "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::DenseGelu, __nv_bfloat16*, int, "
     "int, int)", "B4 MLP forward"),
    ("void (anonymous namespace)::mlp_fwd_out_kernel<(anonymous namespace)::DenseOut>"
     "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::DenseOut, int, int, int)",
     "B4 MLP forward"),
    ("void (anonymous namespace)::mlp_fwd_gelu_kernel<(anonymous namespace)::MlpBlockGelu>"
     "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::MlpBlockGelu, __nv_bfloat16*, "
     "int, int, int)", "B9 MLP block"),
    ("void (anonymous namespace)::mlp_fwd_out_kernel<(anonymous namespace)::MlpBlockOut>"
     "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::MlpBlockOut, int, int, int)",
     "B9 MLP block"),
    ("void (anonymous namespace)::mlp_block_ln_kernel(__nv_bfloat16 const*, float const*, "
     "float const*, __nv_bfloat16*, int, int, float)", "B9 MLP block"),
    ("void (anonymous namespace)::mlp_block_kernel<768>(__nv_bfloat16 const*, ...)",
     "B9 MLP block"),
    ("void (anonymous namespace)::mlp_fwd_kernel<768>(__nv_bfloat16 const*, ...)",
     "B4 MLP forward"),
    ("similarity_kernel(float const*, ...)", "B1 similarity"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "cuBLAS GEMMs"),
    ("Memcpy DtoD (Device -> Device)", "copies and casts"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other elementwise"),
    ("some_unknown_kernel", "other"),
])
def test_bucket_of(name, bucket):
    assert bucket_of(name) == bucket


def test_union_merges_overlaps_and_gaps():
    assert union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25.0


def test_account_of_a_clean_trace():
    """Back-to-back kernels inside the window: busy is their sum, the idle
    share the rest of the window, and the buckets add up to busy."""
    events = [("flash_fwd_kernel", 100.0, 400.0), ("xmma_gemm", 400.0, 900.0),
              ("flash_fwd_kernel", 1100.0, 1400.0), ("xmma_gemm", 1400.0, 1900.0)]
    r = account(events, (0.0, 2000.0), units=2)
    assert r["problems"] == []
    assert r["window_ms"] == pytest.approx(1.0)
    assert r["device_busy_ms"] == pytest.approx(0.8)
    assert r["idle_share"] == pytest.approx(0.2)
    assert r["bucket_sum_ms"] == pytest.approx(r["device_busy_ms"])
    assert list(r["buckets_ms"]) == ["cuBLAS GEMMs", "B3/B5 attention forward"]
    assert r["buckets_ms"]["cuBLAS GEMMs"] == pytest.approx(0.5)


@pytest.mark.parametrize("where", ["before", "after"])
def test_account_fails_device_time_outside_the_window(where):
    """Busy above the window can only come from events outside it: the
    reading is reported as a problem, and the idle share is not clamped."""
    extra = (-500.0, -100.0) if where == "before" else (1900.0, 2500.0)
    events = [("xmma_gemm", 0.0, 1000.0), ("copy_kernel", *extra)]
    r = account(events, (0.0, 1000.0), units=1)
    assert len(r["problems"]) == 1 and "outside the window" in r["problems"][0]
    assert r["outside_window_ms"] > TOL * r["window_ms"]
    assert r["idle_share"] < 0.0


def test_account_fails_overlapping_events():
    """A range that spans other kernels (as a record_function projected onto
    the device would) counts their time twice: the buckets' sum exceeds the
    busy time, and the reading is reported as a problem."""
    events = [("multi_tensor_apply_kernel", 0.0, 100.0),
              ("multi_tensor_apply_kernel", 150.0, 250.0),
              ("Optimizer.step#AdamW.step", 0.0, 250.0)]
    r = account(events, (0.0, 1000.0), units=1)
    assert r["device_busy_ms"] == pytest.approx(0.25)
    assert r["bucket_sum_ms"] == pytest.approx(0.45)
    assert any("overlap" in p for p in r["problems"])


def test_train_batch_at_a_tiny_size():
    """Images of the asked size and reports padded or cut to ``length``
    tokens, the same from the same seed."""
    tok = main_paths.tokenizer()
    a = main_paths.train_batch(np.random.default_rng(3), tok, "cpu", 4, 16)
    b = main_paths.train_batch(np.random.default_rng(3), tok, "cpu", 4, 16)
    assert a["images"].shape == (4, 512, 512, 1) and a["images"].dtype == torch.uint8
    assert a["input_ids"].shape == a["attention_mask"].shape == (4, 16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["attention_mask"].sum(1).max()) == 16  # 8+ words fill 16 tokens


def test_base_lrs_of_the_pretrain_preset():
    preset = get_preset("pretrain_clip")
    lrs = main_paths.base_lrs(preset)
    assert lrs["default"] == preset.train.lr
    assert {g.name for g in preset.train.groups} <= set(lrs)


@pytest.mark.parametrize("name, old_pointers", [("cxr_mlp_fwd", 6), ("cxr_mlp_block", 8),
                                                ("cxr_mlp_bwd", None)])
def test_another_build_is_called_with_its_own_signature(name, old_pointers):
    """``compare_builds.ThisInterface`` calls another build's entry point
    with this checkout's arguments, less the scratch pointers (the last of
    the pointers) that the other build's signature does not take: the MLP
    forwards before they took scratch. An unchanged signature passes every
    argument."""
    import ctypes

    from clip_for_dl_tpu_torch.ops import _build
    from clip_for_dl_tpu_torch.tools.compare_builds import ThisInterface

    ours = _build._SIGNATURES[name]
    n = next(i for i, t in enumerate(ours) if t is not ctypes.c_void_p)
    theirs = ours if old_pointers is None else (ours[:old_pointers] + ours[n:])
    calls = []

    class Lib:
        def __getattr__(self, attr):
            return lambda *args: calls.append((attr, args)) or 0

    args = tuple(range(len(ours)))
    assert getattr(ThisInterface(Lib(), {name: theirs}), name)(*args) == 0
    kept = args if old_pointers is None else args[:old_pointers] + args[n:]
    assert calls == [(name, kept)] and len(kept) == len(theirs)
