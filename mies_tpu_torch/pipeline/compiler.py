"""Compile a PipelineConfig into one callable on [B, H, W] tensors.

The port of ``mies_tpu.pipeline.compiler`` for the ops ported so far.
PyTorch runs eagerly, so "compiling" binds each stage's parameters once;
there is no trace, no cache of programs and no input donation. The chain
runs on the card by default: ``device="cuda"`` moves its input (a tensor
or a numpy array) there, where the batched stages launch the hand-written
kernels of ``mies_tpu_torch.kernels``; ``device="cpu"`` runs their plain
PyTorch versions. Without a card the default raises instead of running
on the CPU.

Batched chains on the card:
  flagship: ingest (uint8 / uint16 -> float [0, 1])
    -> clahe opencv (K1, LUT build, K2) -> bilateral_blur (K3)
    -> unsharp_mask + uint8 quantize as one kernel (K4, the tail peephole);
    under MIES_TPU_FUSE_TAIL=1 (off by default, as in the reference) the
    bilateral -> unsharp -> uint8 tail runs as one kernel instead (K13);
  configs/xray_adapthist_skimage.yaml: ingest
    -> clahe skimage (K1 bins, K6a, K6) -> unsharp + quantize (K4);
  configs/ct_lowdose_nlm.yaml: int16 HU -> window_hu (plain torch)
    -> denoise_nl_means (K11, one launch) -> denoise_tv (K12, three
    launches per chunk of 4 iterations) -> clahe opencv (K1, K2) -> uint8;
  configs/ultrasound_despeckle.yaml: srad (K10, ceil(niter / 2) launches
    of at most 2 iterations) -> lee_filter (plain torch) -> clahe opencv
    (K1, K2) -> uint8;
  anisotropic_diffusion (K9, one launch per iteration) -> musica (plain
    torch), as BASELINE w8;
  BASELINE w3: unsharp_mask -> gaussian_blur as one kernel (K7, the
    pairwise peephole) -> uint8;
  configs/mammogram_sharpen.yaml: uint16 ingest -> gaussian_blur (plain
    torch) -> unsharp + quantize (K4);
  configs/ct_soft_tissue.yaml and configs/ct_guided_denoise.yaml: int16
    HU -> window_hu -> median_blur / guided_blur (plain torch) -> clahe
    opencv (K1, K2) -> unsharp + quantize (K4);
  BASELINE w4: window_hu -> median_blur (plain torch) -> bilateral_blur
    (K3) -> uint8;
  configs/histeq_baseline.yaml and BASELINE w1 (equalize_hist ->
    adjust_gamma), configs/mammo_microcalc_tophat.yaml and BASELINE w7
    (median_blur -> top_hat -> rescale_intensity): plain torch only;
  configs/xray_homomorphic.yaml: uint8 ingest -> homomorphic (plain torch,
    cuFFT) -> unsharp + quantize (K4);
  configs/xray_wavelet_denoise.yaml: denoise_wavelet (plain torch) ->
    clahe opencv (K1, K2) -> uint8;
  configs/angio_vessel_enhance.yaml: uint8 ingest -> median_blur ->
    vessel_enhance -> rescale_intensity: plain torch only;
  denoise_bilateral: K3 where its window max(5, 2 ceil(3 sigma) + 1) is
    at most 9 and its border one of K3's (reflect, mirror, nearest, edge),
    decided when the chain is built; the plain bilateral_blur otherwise;
  the edges, Laplacians, DoG, retinex, Kuwahara, Canny, Richardson-Lucy,
    the rolling ball, the geometry ops and histogram_match are plain torch;
    gabor, gabor_bank and motion_blur one conv2d each (cuDNN, TF32 off);
  learned_denoise: the checkpoint's DnCNN or U-Net (cuDNN convolutions in
    bfloat16), e.g. before clahe opencv (K1, K2) and unsharp + uint8 (K4).
The fraction convention runs K1 and K2 (clip01), kornia plain torch.

Volume chains (``compile_volume_pipeline``, [Z, H, W] -> [Z, H, W]):
  configs/ct_volume_3d.yaml: int16 HU -> window_hu (plain torch)
    -> clahe3d opencv (K1 over the slices, LUT build, K8)
    -> gaussian_blur3d (plain torch) -> uint8;
  clahe3d fraction runs K1 and K8 (clip01), skimage K1 bins, K6a, K8s;
  the reference's other 34 volume ops (the 3-D filters, morphology,
  resample3d, restorations, ridges, frequency and wavelet ops, and the
  intensity ops with the whole volume's statistics) are plain torch.
"""

from __future__ import annotations

import copy
import functools
import os
from typing import Callable

import numpy as np
import torch

from mies_tpu_torch.kernels.bilateral import (
    bilateral_batched,
    denoise_bilateral_batched,
)
from mies_tpu_torch.kernels.clahe import clahe_batched
from mies_tpu_torch.kernels.clahe3d import clahe3d_volume
from mies_tpu_torch.kernels.diffusion import (
    anisotropic_diffusion_batched,
    srad_batched,
)
from mies_tpu_torch.kernels.fused import (
    bilateral_unsharp_cuda,
    bilateral_unsharp_supported,
)
from mies_tpu_torch.kernels.nlmeans import nl_means_batched
from mies_tpu_torch.kernels.tv import denoise_tv_batched
from mies_tpu_torch.kernels.unsharp_gauss import (
    unsharp_gauss_cuda,
    unsharp_gauss_supported,
    unsharp_quant_cuda,
    unsharp_quant_supported,
)
from mies_tpu_torch.ops import feature as FT
from mies_tpu_torch.ops import filters as F
from mies_tpu_torch.ops import frequency as FQ
from mies_tpu_torch.ops import geometry as GEO
from mies_tpu_torch.ops import histogram as H
from mies_tpu_torch.ops import intensity as I
from mies_tpu_torch.ops import morphology as M
from mies_tpu_torch.ops import pyramid as P
from mies_tpu_torch.ops import restoration as R
from mies_tpu_torch.ops import ridges as RG
from mies_tpu_torch.ops import volume3d as V
from mies_tpu_torch.ops import wavelet as WV
from mies_tpu_torch.pipeline.config import PipelineConfig, validate

# Every op a config can name in the port. Signature: fn(img, **params),
# plain PyTorch on [..., H, W]; a statistic of the image (normalize's and
# rescale_intensity's range, the equalizations' histograms) is taken per
# image, so each op is also its own batched form.
OP_REGISTRY: dict[str, Callable] = {
    # intensity
    "adjust_gamma": I.adjust_gamma,
    "adjust_log": I.adjust_log,
    "adjust_sigmoid": I.adjust_sigmoid,
    "invert": I.invert,
    "normalize": I.normalize_minmax,
    "rescale_intensity": I.rescale_intensity,
    "window_hu": I.window_hu,
    "adjust_brightness": I.adjust_brightness,
    "adjust_contrast": I.adjust_contrast,
    "solarize": I.solarize,
    "posterize": I.posterize,
    "sharpness": I.sharpness,
    # histogram
    "equalize_hist": H.equalize_hist,
    "equalize": H.equalize,
    "clahe": H.clahe,
    # filters
    "bilateral_blur": F.bilateral_blur,
    "denoise_bilateral": F.denoise_bilateral,
    "gaussian_blur": F.gaussian_blur,
    "box_blur": F.box_blur,
    "unsharp_mask": F.unsharp_mask,
    "median_blur": F.median_blur,
    "guided_blur": F.guided_blur,
    "sobel_edges": F.sobel_edges,
    "scharr_edges": F.scharr_edges,
    "prewitt_edges": F.prewitt_edges,
    "farid_edges": F.farid_edges,
    "roberts_edges": F.roberts_edges,
    "laplace": F.laplace,
    "laplacian_sharpen": F.laplacian_sharpen,
    "difference_of_gaussians": F.difference_of_gaussians,
    # dense 2-D kernels: one conv2d (cuDNN on the card, TF32 off)
    "gabor": F.gabor,
    "gabor_bank": F.gabor_bank,
    "motion_blur": F.motion_blur,
    "retinex": F.retinex,
    "kuwahara": F.kuwahara,
    "canny": FT.canny,
    "denoise_nl_means": R.denoise_nl_means,
    "denoise_tv": R.denoise_tv,
    "srad": R.srad,
    "anisotropic_diffusion": R.anisotropic_diffusion,
    "lee_filter": F.lee_filter,
    "musica": P.musica,
    # frequency domain (torch.fft: cuFFT on the card)
    "butterworth": FQ.butterworth,
    "homomorphic": FQ.homomorphic,
    # wavelet shrinkage; cycle_spin flattens its shift grid into the batch
    "denoise_wavelet": WV.denoise_wavelet,
    "cycle_spin": WV.cycle_spin,
    # ridge / vesselness (Frangi 1998, Sato 1998, Meijering 2004)
    "frangi": RG.frangi,
    "vessel_enhance": RG.vessel_enhance,
    "sato": RG.sato,
    "meijering": RG.meijering,
    "hessian": RG.hessian,
    # morphology (cv2-compatible flat structuring elements)
    "erode": M.erode,
    "dilate": M.dilate,
    "morph_open": M.morph_open,
    "morph_close": M.morph_close,
    "morph_gradient": M.morph_gradient,
    "top_hat": M.top_hat,
    "black_hat": M.black_hat,
    "subtract_background": M.subtract_background,
    # restoration by deconvolution (torch.fft: cuFFT on the card)
    "wiener": R.wiener,
    "richardson_lucy": R.richardson_lucy,
    # geometry
    "resize": GEO.resize,
    "center_crop": GEO.center_crop,
    "flip": GEO.flip,
    "rot90": GEO.rot90,
    "rotate": GEO.rotate,
    "affine_warp": GEO.affine_warp,
    "perspective_warp": GEO.perspective_warp,
    "normalize_meanstd": GEO.normalize_meanstd,
    "denormalize_meanstd": GEO.denormalize_meanstd,
    # volumetric [Z, H, W] stages: validated here, run by
    # compile_volume_pipeline (2-D chains refuse them by name)
    "clahe3d": V.clahe3d,
    "gaussian_blur3d": V.gaussian_blur3d,
    "guided_blur3d": V.guided_blur3d,
    "median_blur3d": V.median_blur3d,
    "unsharp_mask3d": V.unsharp_mask3d,
    "erode3d": V.erode3d,
    "dilate3d": V.dilate3d,
    "morph_open3d": V.morph_open3d,
    "morph_close3d": V.morph_close3d,
    "morph_gradient3d": V.morph_gradient3d,
    "top_hat3d": V.top_hat3d,
    "black_hat3d": V.black_hat3d,
    "resample3d": V.resample3d,
    "difference_of_gaussians3d": V.difference_of_gaussians3d,
    "denoise_nl_means3d": R.denoise_nl_means3d,
    "denoise_tv3d": R.denoise_tv3d,
    "wiener3d": R.wiener3d,
    "anisotropic_diffusion3d": R.anisotropic_diffusion3d,
    "srad3d": R.srad3d,
    "frangi3d": RG.frangi3d,
    "vessel_enhance3d": RG.vessel_enhance3d,
    "sato3d": RG.sato3d,
    "meijering3d": RG.meijering3d,
    "hessian3d": RG.hessian3d,
    "butterworth3d": FQ.butterworth3d,
    "homomorphic3d": FQ.homomorphic3d,
    "denoise_wavelet3d": WV.denoise_wavelet3d,
}



def _histogram_match_builder(reference: str):
    """Stage builder: load the reference image on the host when the chain
    is built (the port's own ``io.image.load_image``) and keep its
    (values, quantiles) CDF; every processed slice is matched to it."""
    from mies_tpu_torch.io.image import load_image

    try:
        ref = load_image(reference)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"histogram_match stage: reference image {reference!r} not found"
        ) from e
    values, quantiles = (torch.from_numpy(a)
                         for a in H.reference_cdf(np.asarray(ref)))
    on_device = {}

    def stage(img: torch.Tensor) -> torch.Tensor:
        if img.device not in on_device:
            on_device[img.device] = (values.to(img.device),
                                     quantiles.to(img.device))
        return H.match_histograms(img, *on_device[img.device])

    return stage


def _learned_denoise_builder(checkpoint: str):
    """Stage builder: load the denoiser checkpoint once, when the chain is
    built, and run the model on [B, 1, H, W] (bfloat16 compute, as the
    reference). The loaded model stays on the CPU; any other device gets
    its own copy of it at the first call there, so one stage runs on
    several devices in any order."""
    from mies_tpu_torch.models.denoiser import denoise_batch, load_model

    try:
        model = load_model(checkpoint)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"learned_denoise stage: checkpoint {checkpoint!r} not found "
            f"(train one with `python -m mies_tpu_torch train-denoiser -o "
            f"{checkpoint}`)"
        ) from e
    # nn.Module.to moves a module in place: each device gets a copy
    on_device = {torch.device("cpu"): model}

    def stage(img: torch.Tensor) -> torch.Tensor:
        if img.device not in on_device:
            on_device[img.device] = copy.deepcopy(model).to(img.device)
        with torch.no_grad():
            return denoise_batch(on_device[img.device], img)

    return stage


# Ops whose parameters need host-side work when the chain is built (a
# reference image or a checkpoint to load). Signature: builder(**params) ->
# fn(img) -> img.
STAGE_BUILDERS: dict[str, Callable] = {
    "learned_denoise": _learned_denoise_builder,
    "histogram_match": _histogram_match_builder,
}
OP_REGISTRY.update(STAGE_BUILDERS)

# The ops that take only a whole [Z, H, W] volume (the reference's set): a
# 2-D chain refuses them at build time, by name.
VOLUME_ONLY_OPS = frozenset(
    {"clahe3d", "gaussian_blur3d", "guided_blur3d", "median_blur3d",
     "unsharp_mask3d", "erode3d", "dilate3d", "morph_open3d",
     "morph_close3d", "morph_gradient3d", "top_hat3d", "black_hat3d",
     "resample3d", "denoise_nl_means3d", "denoise_tv3d", "frangi3d",
     "vessel_enhance3d", "denoise_wavelet3d", "sato3d", "meijering3d",
     "difference_of_gaussians3d", "butterworth3d", "homomorphic3d",
     "wiener3d", "anisotropic_diffusion3d", "srad3d", "hessian3d"}
)

# Ops with a batched kernel path: fn([B, H, W], **params).
_BATCHED_OPS: dict[str, Callable] = {
    "clahe": clahe_batched,
    "bilateral_blur": bilateral_batched,
    "denoise_bilateral": denoise_bilateral_batched,
    "denoise_nl_means": nl_means_batched,
    "denoise_tv": denoise_tv_batched,
    "srad": srad_batched,
    "anisotropic_diffusion": anisotropic_diffusion_batched,
}


def _check_ported(cfg: PipelineConfig) -> None:
    """Fail at chain-build time for a config the port cannot run (one
    built in code has not been through load_config's checks), including
    the clahe op's own argument rules."""
    validate(cfg)
    for s in cfg.stages:
        if s.op == "clahe":
            kw = s.kwargs()
            H.check_convention(kw.get("convention", "opencv"),
                               kw.get("nbins", H.NBINS))


def _reject_volume_only(cfg: PipelineConfig) -> None:
    """A 2-D chain fails at build time on a volume-only op, with the op
    named (validate accepts them: the same config may drive the volume
    pipeline)."""
    bad = [s.op for s in cfg.stages if s.op in VOLUME_ONLY_OPS]
    if bad:
        raise ValueError(
            f"op(s) {bad} are volume-only ([Z, H, W]); run this config "
            f"through compile_volume_pipeline"
        )


def _bind_batched_stage(s) -> Callable:
    if s.op in STAGE_BUILDERS:
        return STAGE_BUILDERS[s.op](**s.kwargs())
    fn = _BATCHED_OPS.get(s.op, OP_REGISTRY[s.op])
    return functools.partial(fn, **s.kwargs())


def _try_fuse_tail(cfg: PipelineConfig, quantize: bool, dev: torch.device):
    """Peephole: a trailing [bilateral_blur -> unsharp_mask('nearest',
    clip=True)] runs as ONE kernel (K13) with the uint8 quantize folded in,
    bit-equal to K3 -> K4. Only under MIES_TPU_FUSE_TAIL=1 (the reference's
    switch, off by default: measured net negative on v5e) and on the card;
    a tail past K13's limits stays unfused. Decided from the config when
    the chain is built. Returns (prefix_stages, fused_fn | None)."""
    if os.environ.get("MIES_TPU_FUSE_TAIL") != "1":
        return cfg.stages, None
    if dev.type != "cuda" or len(cfg.stages) < 2:
        return cfg.stages, None
    a, b = cfg.stages[-2], cfg.stages[-1]
    if a.op != "bilateral_blur" or b.op != "unsharp_mask":
        return cfg.stages, None
    ak, bk = a.kwargs(), b.kwargs()
    if bk.get("mode", "nearest") != "nearest" or not bk.get("clip", True):
        return cfg.stages, None
    k = int(ak.get("kernel_size", 5))
    mode = ak.get("mode", "reflect")
    radius = float(bk.get("radius", 1.0))
    if not bilateral_unsharp_supported(k, radius, mode):
        return cfg.stages, None
    fused = functools.partial(
        bilateral_unsharp_cuda, kernel_size=k,
        sigma_color=float(ak.get("sigma_color", 0.1)),
        sigma_space=float(ak.get("sigma_space", 1.5)), bilateral_mode=mode,
        radius=radius, amount=float(bk.get("amount", 1.0)),
        quantize=quantize,
    )
    return cfg.stages[:-2], fused


def _try_fuse_unsharp_quant(cfg: PipelineConfig, quantize: bool):
    """Peephole: a trailing unsharp_mask('nearest', clip=True) runs as ONE
    kernel (K4) with the uint8 quantize folded in. Decided from the config
    alone. Returns (prefix_stages, fused_fn | None)."""
    if not cfg.stages or cfg.stages[-1].op != "unsharp_mask":
        return cfg.stages, None
    bk = cfg.stages[-1].kwargs()
    if bk.get("mode", "nearest") != "nearest" or not bk.get("clip", True):
        return cfg.stages, None
    radius = float(bk.get("radius", 1.0))
    truncate = float(bk.get("truncate", 4.0))
    if not unsharp_quant_supported(radius, truncate):
        return cfg.stages, None
    fused = functools.partial(
        unsharp_quant_cuda, radius=radius, amount=float(bk.get("amount", 1.0)),
        truncate=truncate, quantize=quantize,
    )
    return cfg.stages[:-1], fused


def _try_fuse_unsharp_gauss(a, b):
    """Peephole: adjacent [unsharp_mask -> gaussian_blur], both 'nearest'
    and the unsharp clipped, with one truncate, run as ONE kernel (K7,
    BASELINE w3), bit-exact against the pair. Decided from the config
    alone. Returns the fused batched fn, or None."""
    if a.op != "unsharp_mask" or b.op != "gaussian_blur":
        return None
    ak, bk = a.kwargs(), b.kwargs()
    if ak.get("mode", "nearest") != "nearest" or not ak.get("clip", True):
        return None
    if bk.get("mode", "nearest") != "nearest":
        return None
    # unsharp_mask's own Gaussian is truncated at 4 sigma
    truncate = float(bk.get("truncate", 4.0))
    if truncate != 4.0:
        return None
    radius = float(ak.get("radius", 1.0))
    sigma = float(bk.get("sigma", 1.0))
    if not unsharp_gauss_supported(radius, sigma, truncate):
        return None
    return functools.partial(
        unsharp_gauss_cuda, radius=radius, amount=float(ak.get("amount", 1.0)),
        sigma=sigma, truncate=truncate,
    )


def _bind_named_stages(stages) -> list[tuple[str, Callable]]:
    """(op name, batched fn) of each stage, adjacent pairs the pairwise
    peephole fuses bound as one ("unsharp_mask+gaussian_blur")."""
    bound, i = [], 0
    while i < len(stages):
        if i + 1 < len(stages):
            fused = _try_fuse_unsharp_gauss(stages[i], stages[i + 1])
            if fused is not None:
                bound.append((f"{stages[i].op}+{stages[i + 1].op}", fused))
                i += 2
                continue
        bound.append((stages[i].op, _bind_batched_stage(stages[i])))
        i += 1
    return bound


def _bind_stages(stages) -> list[Callable]:
    """The batched fns of ``_bind_named_stages``."""
    return [fn for _, fn in _bind_named_stages(stages)]


def resolve_device(device) -> torch.device:
    """The chain's device: "cuda" (any CUDA device) or "cpu". Asked for a
    card where there is none, raise: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch.cuda.is_available() is "
            f"False; pass device='cpu' for the plain PyTorch chain"
        )
    return dev


def _to_device(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        # a decoded image may be a read-only view (Pillow, a memmap), which
        # torch.from_numpy wraps only with a warning: copy it first
        x = torch.from_numpy(x if x.flags.writeable else np.array(x))
    return x.to(dev)


def build_batched_chain(
    cfg: PipelineConfig, quantize: bool | None = None, device="cuda"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batch-level chain [B, H, W] -> [B, H, W] on ``device`` (the input,
    a tensor or numpy array, is moved there first).

    When ``quantize`` is not None the chain also owns the final uint8
    conversion (quantize=True), which lets the unsharp tail fuse with it.
    The peepholes run in the reference's order: the opt-in bilateral ->
    unsharp tail (K13) first, then the quantize tail (K4), then the
    adjacent pairs (K7).
    """
    _check_ported(cfg)
    _reject_volume_only(cfg)
    dev = resolve_device(device)
    stages, fused_tail = cfg.stages, None
    if quantize is not None:
        stages, fused_tail = _try_fuse_tail(cfg, bool(quantize), dev)
        if fused_tail is None:
            stages, fused_tail = _try_fuse_unsharp_quant(cfg, bool(quantize))
    bound = _bind_named_stages(stages)
    if fused_tail is not None:
        bound.append(("+".join(s.op for s in cfg.stages[len(stages):]),
                      fused_tail))

    def chain(batch: torch.Tensor) -> torch.Tensor:
        x = _ingest(_to_device(batch, dev))
        # `stage` is the running op's name, which the device timers read
        # from this frame when a stage cannot be captured (runner.py)
        for stage, fn in bound:
            x = fn(x)
        return _quantize_u8(x) if quantize and fused_tail is None else x

    return chain


def build_chain(
    cfg: PipelineConfig, device="cuda"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """One-slice chain [H, W] -> [H, W] float on ``device``: the batched
    chain on a batch of one."""
    bchain = build_batched_chain(cfg, device=device)
    return lambda img: bchain(img[None])[0]


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8 (round-half-even like cv2/np.rint, clipped)."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def _ingest(x: torch.Tensor) -> torch.Tensor:
    """Normalize integer inputs to the float [0, 1] convention on the
    input's device (uint8 / 255, uint16 / 65535, by true division — a
    tensor divisor, since CUDA torch multiplies by the reciprocal of a
    Python scalar); floating inputs become float32; int16 (CT Hounsfield
    units) passes through for window_hu."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / torch.full((), 255.0, device=x.device)
    if x.dtype == torch.uint16:
        return x.to(torch.float32) / torch.full((), 65535.0, device=x.device)
    if x.is_floating_point():
        return x.to(torch.float32).contiguous()
    return x


def compile_pipeline(
    cfg: PipelineConfig, batched: bool = False, quantize: bool = True,
    device="cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Config -> callable that runs on ``device``.

    batched=False: input [H, W] (or [C, H, W] per-channel); batched=True:
    input [B, H, W] (or [B, C, H, W], channels folded into the batch); a
    tensor or numpy array, moved to ``device`` first. quantize=True ends
    the chain in uint8. ``device="cuda"`` (the default) runs the kernels
    on the card and raises RuntimeError where there is none;
    ``device="cpu"`` runs the plain PyTorch versions.
    """
    dev = resolve_device(device)
    bchain = build_batched_chain(cfg, quantize=quantize, device=dev)

    def run(x: torch.Tensor) -> torch.Tensor:
        x = _to_device(x, dev)
        if batched and x.dim() == 4:
            b, c = x.shape[:2]
            out = bchain(x.reshape(b * c, *x.shape[2:]))
            return out.reshape(b, c, *out.shape[1:])
        if batched or x.dim() == 3:
            return bchain(x)
        return bchain(x[None])[0]

    return run


# ---------------------------------------------------------------------------
# Volume-level (3-D) pipelines
# ---------------------------------------------------------------------------


def _volume_registry() -> dict[str, Callable]:
    """Ops the volume pipeline runs on a whole [Z, H, W] volume: the
    reference's 37. A statistic (equalize_hist's histogram, normalize's and
    rescale_intensity's range) is the WHOLE volume's, as in the reference's
    volume program; the 2-D registry's forms would take each slice's."""
    return {
        **{name: OP_REGISTRY[name] for name in VOLUME_ONLY_OPS},
        "clahe3d": clahe3d_volume,
        "equalize_hist": V.equalize_hist_volume,
        "normalize": V.normalize_volume,
        "rescale_intensity": V.rescale_intensity_volume,
        # pointwise, shape-polymorphic
        **{name: OP_REGISTRY[name] for name in (
            "window_hu", "adjust_gamma", "adjust_log", "adjust_sigmoid",
            "invert", "normalize_meanstd", "denormalize_meanstd")},
    }


def compile_volume_pipeline(
    cfg: PipelineConfig, quantize: bool = True, device="cuda"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Config -> [Z, H, W] -> [Z, H, W] whole-volume program on ``device``.

    The volume is one 3-D array, so volumetric stages (clahe3d,
    gaussian_blur3d, ...) see the z axis; resample3d changes its shape. As in the reference there is no
    ingest step: an int16 volume goes straight to window_hu. quantize=True
    ends in uint8. ``device="cuda"`` (the default) launches the kernels
    and raises RuntimeError where there is no card; ``device="cpu"`` runs
    the plain PyTorch versions."""
    validate(cfg)
    reg = _volume_registry()
    bound = []
    for s in cfg.stages:
        if s.op not in reg:
            raise ValueError(
                f"op {s.op!r} is not volume-capable in mies_tpu_torch; "
                f"available: {sorted(reg)}"
            )
        bound.append(functools.partial(reg[s.op], **s.kwargs()))
    dev = resolve_device(device)

    def run(vol: torch.Tensor) -> torch.Tensor:
        x = _to_device(vol, dev)
        for fn in bound:
            x = fn(x)
        return _quantize_u8(x) if quantize else x

    return run
