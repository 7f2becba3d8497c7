"""The port's learned denoisers (``mies_tpu_torch.models``) against the JAX
package's flax models, the weight carrying, the checkpoints and the
``learned_denoise`` stage.

* DnCNN (depth 3) and U-Net (2 levels), features 8, on [2, 32, 32] and
  [2, 33, 47] (the U-Net's reflect pad and crop, its stride-2 'SAME' pad
  of (0, 1)), from one flax parameter tree carried across by
  ``flax_to_torch``: at float32 (``dtype=jnp.float32`` on the flax side)
  within 1e-5; at the default bfloat16 within 8e-3 on [0, 1] input (4
  bfloat16 ulps at 0.25-0.5: a sum rounded to bf16 in another order lands
  an ulp apart now and then, and the next layers carry it).
* ``torch_to_flax`` gives back the reference's tree, names and values;
  the initialisers draw flax's distributions.
* A checkpoint written by the reference's ``save_denoiser`` (orbax),
  converted by ``tools/convert_denoiser_ckpt.py``, runs as a
  ``learned_denoise`` stage in both packages' batched chains (float out
  within the bf16 bound); the port's own checkpoints round-trip, an
  orbax-only directory is refused naming the converter.

The file imports jax only inside the CPU tests; the card test (marker
``cuda``) runs as ``python -m pytest tests/test_torch_models.py
--noconftest -m cuda``.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from pytest import skip

import mies_tpu_torch
from mies_tpu_torch.kernels import _build
from mies_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from mies_tpu_torch.models.denoiser import (
    Conv3x3,
    build_model,
    denoise_batch,
    init_params,
    load_denoiser,
    load_model,
    save_denoiser,
)
from mies_tpu_torch.pipeline.config import PipelineConfig

REPO = Path(__file__).resolve().parent.parent
BF16_BOUND = 8e-3
torch.set_num_threads(2)


def _flax_model(arch, depth, dtype):
    import jax.numpy as jnp

    from mies_tpu.models.denoiser import DenoiserCNN
    from mies_tpu.models.unet import UNetDenoiser

    dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    if arch == "dncnn":
        return DenoiserCNN(features=8, depth=depth, dtype=dt)
    return UNetDenoiser(features=8, levels=depth, dtype=dt)


@functools.lru_cache(maxsize=None)
def _flax_tree(arch, depth, features=8):
    """One flax parameter tree a family (float32 parameters whatever the
    compute dtype), initialised from PRNGKey(1)."""
    import jax
    import jax.numpy as jnp

    model = _flax_model(arch, depth, "float32").clone(features=features)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 1)))
    return jax.tree_util.tree_map(np.asarray, params)


FORWARD = [(a, d, s, dt) for a, d in (("dncnn", 3), ("unet", 2))
           for s in ((32, 32), (33, 47)) for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,depth,shape,dtype", FORWARD,
                         ids=[f"{a}-{s[0]}x{s[1]}-{dt}"
                              for a, _, s, dt in FORWARD])
def test_forward_equals_flax(arch, depth, shape, dtype):
    import jax.numpy as jnp

    fm = _flax_model(arch, depth, dtype)
    params = _flax_tree(arch, depth)
    x = np.random.default_rng(0).random((2, *shape, 1)).astype(np.float32)
    want = np.asarray(fm.apply(params, jnp.asarray(x)))
    model = build_model(arch, 8, depth, dtype=getattr(torch, dtype))
    model.load_state_dict(flax_to_torch(params, arch, 8, depth))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (2, 1, *shape)
    bound = 1e-5 if dtype == "float32" else BF16_BOUND
    d = np.abs(got.permute(0, 2, 3, 1).numpy() - want).max()
    assert d <= bound, d


@pytest.mark.parametrize("arch,depth", [("dncnn", 4), ("unet", 3)])
def test_weight_carrying_round_trips_the_flax_tree(arch, depth):
    """flax -> torch -> flax gives the reference's tree back, its names as
    init gives them (remat renames its blocks Checkpoint_*), its values
    exactly; the state dict has the port model's keys and shapes."""
    import jax

    params = _flax_tree(arch, depth)
    state = flax_to_torch(params, arch, 8, depth)
    want = build_model(arch, 8, depth).state_dict()
    assert {k: v.shape for k, v in state.items()} == \
        {k: v.shape for k, v in want.items()}
    back = torch_to_flax(state, arch, 8, depth)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="flax module name"):
        flax_to_torch({"params": {"Dense": {}}}, arch, 8, depth)


def test_initialisers_draw_flax_distributions():
    """lecun_normal kernels (truncated at 2 sigma, variance 1 / fan_in)
    and zero biases, from an explicit generator: the same seed gives the
    same model, another seed another one; the kernels' spread is flax's
    within sampling error."""
    import jax

    a, b = init_params(3, 64, 6), init_params(3, 64, 6)
    for (ka, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), ka
    assert not torch.equal(init_params(4, 64, 6).convs[2].weight,
                           a.convs[2].weight)
    fl = _flax_tree("dncnn", 6, 64)
    for conv in a.modules():
        if isinstance(conv, Conv3x3):
            assert torch.count_nonzero(conv.bias) == 0
    w = a.convs[2].weight.detach().numpy().ravel()  # fan_in 576
    wf = fl["params"]["Checkpoint_MidBlock_1"]["Conv_0"]["kernel"].ravel()
    std = math.sqrt(1.0 / 576)
    assert abs(w.std() - std) < 0.03 * std and abs(wf.std() - std) < 0.03 * std
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7
    del jax


def test_remat_leaves_the_result_and_gradient_unchanged():
    """The middle blocks under activation checkpointing while training:
    the same output and gradients as without."""
    torch.manual_seed(0)
    x = torch.rand(2, 1, 24, 24)
    for arch, depth in (("dncnn", 4), ("unet", 2)):
        model = init_params(0, 8, depth, arch, dtype=torch.float32)
        grads = []
        for training in (True, False):
            model.train(training)
            model.zero_grad()
            out = model(x)
            out.square().sum().backward()
            grads.append((out.detach(),
                          [p.grad.clone() for p in model.parameters()]))
        assert torch.equal(grads[0][0], grads[1][0])
        for g0, g1 in zip(grads[0][1], grads[1][1]):
            assert torch.equal(g0, g1)


def test_checkpoints_round_trip_and_refuse_orbax(tmp_path):
    model = init_params(5, 8, 3)
    save_denoiser(tmp_path / "ck", model, 8, 3, arch="dncnn")
    assert json.loads((tmp_path / "ck" / "meta.json").read_text()) == \
        {"features": 8, "depth": 3, "arch": "dncnn"}
    state, features, depth, arch = load_denoiser(tmp_path / "ck")
    assert (features, depth, arch) == (8, 3, "dncnn")
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v)
    # an older checkpoint without 'arch' loads as dncnn
    (tmp_path / "ck" / "meta.json").write_text('{"features": 8, "depth": 3}')
    assert load_model(tmp_path / "ck").depth == 3
    (tmp_path / "orbax" / "params").mkdir(parents=True)
    (tmp_path / "orbax" / "meta.json").write_text('{"features": 8, "depth": 3}')
    with pytest.raises(ValueError, match="convert_denoiser_ckpt.py"):
        load_denoiser(tmp_path / "orbax")
    with pytest.raises(FileNotFoundError, match="train one with"):
        mies_tpu_torch.compile_pipeline(PipelineConfig.make(
            [("learned_denoise", {"checkpoint": str(tmp_path / "none")})]),
            device="cpu")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "convert_denoiser_ckpt", REPO / "tools" / "convert_denoiser_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,depth", [("dncnn", 3), ("unet", 2)])
def test_orbax_checkpoint_converts_and_runs_in_both_chains(tmp_path, arch,
                                                           depth):
    """The reference's save_denoiser (orbax) -> the converter -> a
    learned_denoise stage in both packages' batched chains on the same
    [2, 33, 47] batch: the float outputs within the bf16 bound."""
    import jax.numpy as jnp

    import mies_tpu
    from mies_tpu.models.denoiser import save_denoiser as jax_save

    jax_save(tmp_path / "orbax", _flax_tree(arch, depth), 8, depth, arch=arch)
    res = _tool().convert(tmp_path / "orbax", tmp_path / "torch")
    assert (res["arch"], res["depth"], res["features"]) == (arch, depth, 8)
    x = np.random.default_rng(9).random((2, 33, 47)).astype(np.float32)

    def cfg(mod, ck):
        return mod.PipelineConfig.make(
            [("learned_denoise", {"checkpoint": str(tmp_path / ck)})])

    want = np.asarray(mies_tpu.compile_pipeline(
        cfg(mies_tpu, "orbax"), batched=True, quantize=False,
        donate=False)(jnp.asarray(x)))
    got = mies_tpu_torch.compile_pipeline(
        cfg(mies_tpu_torch, "torch"), batched=True, quantize=False,
        device="cpu")(x).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= BF16_BOUND


def test_learned_stage_keeps_one_model_per_device(tmp_path):
    """One learned_denoise stage called on the CPU, on the meta device and
    on the CPU again: each device runs its own copy of the model, so the
    meta call gives a meta tensor of the batch's shape and the two CPU
    results are bit-equal to each other and to a stage built fresh."""
    from mies_tpu_torch.pipeline.compiler import OP_REGISTRY

    save_denoiser(tmp_path / "ck", init_params(3, 8, 3), 8, 3)
    build = OP_REGISTRY["learned_denoise"]
    stage = build(checkpoint=str(tmp_path / "ck"))
    x = torch.from_numpy(
        np.random.default_rng(4).random((2, 24, 20), dtype=np.float32))
    first = stage(x)
    on_meta = stage(x.to("meta"))
    assert on_meta.device.type == "meta" and on_meta.shape == x.shape
    again = stage(x)
    assert again.device.type == "cpu"
    assert torch.equal(first, again)
    assert torch.equal(again, build(checkpoint=str(tmp_path / "ck"))(x))


def test_learned_denoise_is_registered_with_its_value_rule(tmp_path):
    from mies_tpu_torch.pipeline.compiler import OP_REGISTRY, STAGE_BUILDERS
    from mies_tpu_torch.pipeline.config import load_config

    assert "learned_denoise" in OP_REGISTRY and "learned_denoise" in STAGE_BUILDERS
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"pipeline": [{"op": "learned_denoise",
                                           "checkpoint": ""}]}))
    with pytest.raises(ValueError, match="expected a checkpoint path"):
        load_config(p)


# --- the card -----------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_learned_chain_on_card_equals_cpu(cuda_device, tmp_path):
    """learned_denoise -> clahe opencv -> unsharp_mask + uint8 on the card:
    K1 to the LUTs, K2 and K4 once a call; the model in bfloat16 there;
    the float learned stage within the bf16 bound of the CPU's and the
    uint8 output equal to the same chain with the plain CLAHE and tail on
    the card."""
    save_denoiser(tmp_path / "ck", init_params(2, 8, 3), 8, 3)
    stages = [("learned_denoise", {"checkpoint": str(tmp_path / "ck")}),
              ("clahe", {"clip_limit": 2.0, "grid_size": (8, 8)}),
              ("unsharp_mask", {"radius": 1.5, "amount": 1.0})]
    cfg = PipelineConfig.make(stages)
    x = torch.rand(4, 256, 256, generator=torch.Generator().manual_seed(0))
    fn = mies_tpu_torch.compile_pipeline(cfg, batched=True, device=cuda_device)
    fn(x)
    _build.reset_launches()
    out = fn(x)
    torch.cuda.synchronize()
    want = {k: int(k in ("tile_luts", "clahe_apply_lut", "unsharp_quant"))
            for k in _build.LAUNCHES}
    assert dict(_build.LAUNCHES) == want
    model = load_model(tmp_path / "ck", cuda_device)
    assert model.convs[0].weight.dtype == torch.float32
    assert model.dtype == torch.bfloat16
    with torch.no_grad():
        den = denoise_batch(model, x.to(cuda_device))
        den_cpu = denoise_batch(load_model(tmp_path / "ck"), x)
    assert (den.cpu() - den_cpu).abs().max().item() <= BF16_BOUND
    from mies_tpu_torch.ops import filters as F
    from mies_tpu_torch.ops import histogram as H
    from mies_tpu_torch.pipeline.compiler import _quantize_u8

    plain = _quantize_u8(F.unsharp_mask(H.clahe(den, 2.0, (8, 8)), 1.5, 1.0))
    assert torch.equal(out, plain)
