"""The plain reference of nerfacto's train step (Tancik et al., "Nerfstudio", SIGGRAPH 2023,
arXiv 2302.04264, as nerfstudio's ``nerfacto`` model and its ``nerfacto-huge`` preset run it), in
plain PyTorch and float32, for the ``nerfacto-huge.train`` cell. It imports nothing of the port and
none of its kernels; the hash encode, the spaced and pdf samplers, the rays, the camera optimizer, the
distortion loss and the ray generation are this package's plain versions. TF32 is off for matmuls and
cuDNN while it runs.

A step renders the batch's camera rays and takes Adam's step on them:

* rays: the patches' pixel centres, posed by the SO3xR3 camera optimizer; near 0.05 and far 1000;
* samples: nerfstudio's UniformLinDispPiecewiseSampler (half the spacing domain linear in distance
  up to 1, half linear in disparity) stratified by one jitter a ray, then two proposal rounds, each a
  hash grid and a small MLP (``trunc_exp`` density) whose weights, raised to the anneal's exponent,
  the PDFSampler inverts (histogram padding 0.01), and the field's samples last;
* field: the L-inf scene contraction of the sample centres, a 16-level hash grid, the density MLP
  (density and a 15-wide geometry feature), the degree-4 SH of the unit direction and the frame's
  appearance embedding into the colour MLP, a sigmoid;
* render: weights from the densities, the colour over the last sample's colour as background (clipped
  to [0, 1]), accumulation and expected depth;
* losses: the colour MSE, MipNeRF-360's interlevel loss (nerfstudio's ``outer`` and
  ``lossfun_outer``, written here as nerfstudio writes them) over the proposal rounds, the distortion
  loss of the field's samples at 0.002, and the camera optimizer's regularizer; gradients by autograd;
* a plain Adam over every parameter (optax's: eps 1e-15 outside the root, bias-corrected moments) at
  the rate of a linear warm-up then a log-linear decay.

The rays run in blocks of ``block_rays`` so that a step fits on one card: each block's loss terms are
weighted by its share of the rays (every term but the regularizer is a mean over rays), its backward
runs before the next block's forward, and the gradients add up.

Where these definitions, the JAX package's, depart from nerfstudio's: the proposal networks are
trained at every step (nerfstudio updates them every 5th step past step 5,000); the anneal exponent
is a function of the step index (nerfstudio's callback sets it before each step, to the same value);
the jitter is drawn from the caller's generator; the camera optimizer's regularizer is the JAX
package's (L2 norms of the translation and rotation, averaged over frames, at 1e-2 and 1e-3).

``lowered=True`` computes the same step one precision below float32: the hash grids take their
positions and tables in bfloat16 and the MLPs compute in bfloat16, as the port's bf16 presets do; the
precision control of the cell's correctness check.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from reference.nrref.cameras.camera_optimizers import CameraOptimizer, CameraOptimizerConfig
from reference.nrref.cameras.rays import RayBundle, RaySamples
from reference.nrref.data.datamanager import batch_to_device, build_sensor_tables, build_train_bundle
from reference.nrref.data.dataparsers.base import DataparserOutputs
from reference.nrref.engine.schedulers import ExponentialDecaySchedulerConfig
from reference.nrref.field_components.encodings import HashEncoding, SHEncoding
from reference.nrref.field_components.mlp import MLP
from reference.nrref.fields.neurad_field import trunc_exp
from reference.nrref.model_components.losses import lossfun_distortion, ray_samples_to_sdist
from reference.nrref.model_components.ray_samplers import draw_jitter, pdf_sampler, spaced_sampler
from reference.nrref.models.neuradar import SegmentLayout

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-15
EPS = 1e-7


@dataclass
class NerfactoSettings:
    """The model and trainer settings of a configuration file's ``model`` entry."""

    hidden_dim: int
    hidden_dim_color: int
    num_levels: int
    base_res: int
    max_res: int
    log2_hashmap_size: int
    features_per_level: int
    num_proposal_samples_per_ray: Sequence[int]
    num_nerf_samples_per_ray: int
    proposal_net_args_list: Sequence[Dict]
    appearance_embedding_dim: int
    near_plane: float
    far_plane: float
    interlevel_loss_mult: float
    distortion_loss_mult: float
    use_single_jitter: bool
    camera_optimizer: str
    proposal_weights_anneal_slope: float
    proposal_weights_anneal_max_num_iters: int
    lr_init: float
    lr_final: float
    warmup_steps: int
    max_num_iterations: int
    num_rgb_patches: int
    patch_size: int


def settings_of(model: Dict) -> NerfactoSettings:
    fields = {f.name for f in dataclasses.fields(NerfactoSettings)}
    return NerfactoSettings(**{k: v for k, v in model.items() if k in fields})


def _contract(x: torch.Tensor, scale: float) -> torch.Tensor:
    """MipNeRF-360's L-inf contraction of x / scale, mapped from [-2, 2]^3 to [0, 1]^3."""
    x = x / scale
    mag = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    clamped = torch.clamp(mag, min=1.0)
    return (torch.where(mag < 1, x, (2 - 1 / clamped) * (x / clamped)) + 2.0) / 4.0


def _positions(samples: RaySamples) -> torch.Tensor:
    f = samples.frustums
    return f.origins[..., None, :] + f.directions[..., None, :] * ((f.starts + f.ends) / 2.0)


class _Field(nn.Module):
    """The nerfacto field; module names as the port's (and the flax tree's)."""

    def __init__(self, s: NerfactoSettings, scale: float, num_embeds: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.scale = scale
        self.grid = HashEncoding(s.num_levels, s.base_res, s.max_res, s.log2_hashmap_size, s.features_per_level,
                                 compute_dtype=dtype)
        self.mlp_base = MLP(self.grid.get_out_dim(), 16, 2, s.hidden_dim, compute_dtype=dtype)
        self.direction_encoding = SHEncoding(4)
        self.mlp_head = MLP(16 + 15 + s.appearance_embedding_dim, 3, 3, s.hidden_dim_color, compute_dtype=dtype)
        self.appearance = nn.Embedding(num_embeds, s.appearance_embedding_dim)

    def forward(self, samples: RaySamples, cam_idx: torch.Tensor):
        pos = _positions(samples)
        R, S = pos.shape[:2]
        h = self.mlp_base(self.grid(_contract(pos, self.scale)))
        dirs = samples.frustums.directions[:, None, :].expand(pos.shape)
        emb = self.appearance(cam_idx.reshape(R).long())[:, None, :].expand(R, S, -1)
        out = self.mlp_head(torch.cat([self.direction_encoding(dirs), h[..., 1:], emb], dim=-1))
        return trunc_exp(h[..., :1]), torch.sigmoid(out)


class _Proposal(nn.Module):
    def __init__(self, args: Dict, scale: float, dtype: Optional[torch.dtype]):
        super().__init__()
        self.scale = scale
        self.grid = HashEncoding(args["num_levels"], 16, args["max_res"], args["log2_hashmap_size"], 2,
                                 compute_dtype=dtype)
        if args["use_linear"]:
            raise ValueError("the reference's proposal networks are MLPs, as the configuration's")
        self.decoder = MLP(self.grid.get_out_dim(), 1, 2, args["hidden_dim"], compute_dtype=dtype)

    def forward(self, samples: RaySamples) -> torch.Tensor:
        return trunc_exp(self.decoder(self.grid(_contract(_positions(samples), self.scale))))


def lin_disp_sampler(bundle: RayBundle, n: int, jitter: Optional[torch.Tensor]) -> RaySamples:
    return spaced_sampler(bundle, n, lambda x: torch.where(x < 1, x / 2, 1 - 1 / (2 * x)),
                          lambda x: torch.where(x < 0.5, 2 * x, 1 / (2 - 2 * x)), jitter)


def outer(t0_starts, t0_ends, t1_starts, t1_ends, y1):
    """nerfstudio's ``outer``: for each bin of t0, the y1 mass of the t1 bins it overlaps."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    idx_lo = torch.searchsorted(t1_starts.contiguous(), t0_starts.contiguous(), side="right") - 1
    idx_lo = torch.clamp(idx_lo, min=0, max=y1.shape[-1] - 1)
    idx_hi = torch.searchsorted(t1_ends.contiguous(), t0_ends.contiguous(), side="right")
    idx_hi = torch.clamp(idx_hi, min=0, max=y1.shape[-1] - 1)
    return torch.take_along_dim(cy1[..., 1:], idx_hi, dim=-1) - torch.take_along_dim(cy1[..., :-1], idx_lo, dim=-1)


def lossfun_outer(t, w, t_env, w_env):
    """nerfstudio's ``lossfun_outer``."""
    w_outer = outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return torch.clip(w - w_outer, min=0) ** 2 / (w + EPS)


class NerfactoReference(nn.Module):
    def __init__(self, s: NerfactoSettings, scale: float, num_embeds: int, lowered: bool = False):
        super().__init__()
        self.s = s
        dtype = torch.bfloat16 if lowered else None
        self.field = _Field(s, scale, num_embeds, dtype)
        args = s.proposal_net_args_list
        self.rounds = len(s.num_proposal_samples_per_ray)
        for i in range(self.rounds):
            self.add_module(f"proposal_{i}", _Proposal(args[min(i, len(args) - 1)], scale, dtype))
        self.camera_optimizer = CameraOptimizer(CameraOptimizerConfig(mode=s.camera_optimizer), num_embeds)

    def anneal(self, step: int) -> float:
        x = min(max(step / self.s.proposal_weights_anneal_max_num_iters, 0.0), 1.0)
        b = self.s.proposal_weights_anneal_slope
        return b * x / ((b - 1) * x + 1)

    def block(self, bundle: RayBundle, jitter: List[torch.Tensor], anneal: float):
        """(rgb, accumulation and depth [r, *], the interlevel and distortion losses' means) of a
        block of train rays."""
        s = self.s
        bundle = dataclasses.replace(bundle, nears=torch.full_like(bundle.pixel_area, s.near_plane),
                                     fars=torch.full_like(bundle.pixel_area, s.far_plane))
        bundle = self.camera_optimizer.apply_to_raybundle(bundle)
        samples = lin_disp_sampler(bundle, s.num_proposal_samples_per_ray[0], jitter[0])
        weights_list, samples_list = [], []
        for i in range(self.rounds):
            w = samples.get_weights(getattr(self, f"proposal_{i}")(samples))
            weights_list.append(w)
            samples_list.append(samples)
            n = s.num_proposal_samples_per_ray[i + 1] if i + 1 < self.rounds else s.num_nerf_samples_per_ray
            samples = pdf_sampler(bundle, samples, w**anneal, n, jitter=jitter[i + 1])
        density, rgb = self.field(samples, bundle.camera_indices[..., 0])
        w = samples.get_weights(density)
        acc = torch.sum(w, dim=-2)
        steps = (samples.frustums.starts + samples.frustums.ends) / 2.0
        depth = torch.sum(w * steps, dim=-2) / (acc + 1e-10)
        outputs = {"rgb": torch.clamp(torch.sum(w * rgb, dim=-2) + rgb[..., -1, :] * (1.0 - acc), 0.0, 1.0),
                   "accumulation": acc,
                   "depth": torch.clamp(depth, torch.amin(steps, dim=-2), torch.amax(steps, dim=-2))}
        c, wf = ray_samples_to_sdist(samples).detach(), w[..., 0].detach()
        interlevel = sum(torch.mean(lossfun_outer(c, wf, ray_samples_to_sdist(rs), wp[..., 0]))
                         for rs, wp in zip(samples_list, weights_list))
        distortion = torch.mean(lossfun_distortion(ray_samples_to_sdist(samples), w[..., 0]))
        return outputs, {"interlevel_loss": s.interlevel_loss_mult * interlevel,
                         "distortion_loss": s.distortion_loss_mult * distortion}


class NerfactoRun:
    """The reference model on a scene, following recorded train steps from given parameters."""

    def __init__(self, settings: NerfactoSettings, outputs: DataparserOutputs, device, lowered: bool = False,
                 block_rays: int = 4096):
        self.s = settings
        self.device = torch.device(device)
        self.tables = build_sensor_tables(outputs, self.device)
        self.layout = SegmentLayout(num_cam=settings.num_rgb_patches * settings.patch_size**2,
                                    patch_size=(settings.patch_size, settings.patch_size))
        with self.device:
            self.model = NerfactoReference(settings, float(np.abs(outputs.scene_box.aabb).max()),
                                           max(len(outputs.camera_to_worlds), 1), lowered)
        self.block_rays = block_rays
        self.schedule = ExponentialDecaySchedulerConfig(lr_final=settings.lr_final, warmup_steps=settings.warmup_steps,
                                                        max_steps=settings.max_num_iterations,
                                                        ramp="linear").build(settings.lr_init)

    def loss_and_grads(self, batch: Dict[str, np.ndarray], generator: torch.Generator, step: int):
        """(total loss, loss terms, outputs [R, *]) of one host batch, on the host as floats and on
        the device; the gradients are left in ``.grad``."""
        s, model = self.s, self.model
        dev = batch_to_device(batch, self.device)
        bundle = build_train_bundle(self.tables, dev, self.layout, 1)
        gt = dev["image"].float().reshape(-1, 3) / 255.0
        R = bundle.num_rays
        jitter = draw_jitter(generator, R, (*s.num_proposal_samples_per_ray, s.num_nerf_samples_per_ray),
                             s.use_single_jitter, self.device)
        anneal = self.model.anneal(step)
        model.zero_grad(set_to_none=True)
        terms = {"rgb_loss": 0.0, "interlevel_loss": 0.0, "distortion_loss": 0.0}
        outs = []
        for a in range(0, R, self.block_rays):
            sl = slice(a, min(R, a + self.block_rays))
            part = RayBundle(origins=bundle.origins[sl], directions=bundle.directions[sl],
                             pixel_area=bundle.pixel_area[sl], camera_indices=bundle.camera_indices[sl])
            out, block_terms = model.block(part, [j[sl] for j in jitter], anneal)
            block_terms["rgb_loss"] = torch.mean((gt[sl] - out["rgb"]) ** 2)
            share = (sl.stop - sl.start) / R
            loss = share * sum(block_terms.values())
            loss.backward()
            for k, v in block_terms.items():
                terms[k] += share * float(v.detach())
            outs.append({k: v.detach() for k, v in out.items()})
        reg = model.camera_optimizer.regularization_loss()
        reg.backward()
        terms["camera_opt_regularizer"] = float(reg.detach())
        return sum(terms.values()), terms, {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    @torch.no_grad()
    def adam(self, state: Dict, step: int, t: int) -> None:
        """One Adam update of every parameter with a gradient (``t``: the update's count from 1)."""
        lr = self.schedule(step)
        b1, b2 = BETAS
        for name, p in self.model.named_parameters():
            if p.grad is None:
                continue
            m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m.mul_(b1).add_(p.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            p.sub_(lr * (m / (1 - b1**t)) / ((v / (1 - b2**t)).sqrt() + ADAM_EPS))

    def follow(self, params: Dict[str, torch.Tensor], batches: Sequence[Dict[str, np.ndarray]],
               generator_states: Sequence[torch.Tensor], start_step: int) -> Dict:
        """From ``params`` (the port's state dict), the recorded steps: each step's loss, the first
        step's rendered rgb and gradients, and the parameters after the last step."""
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, False
        self.model.load_state_dict({k: v.to(self.device) for k, v in params.items()})
        state, losses, grads, rgb = {}, [], None, None
        for k, (batch, gen_state) in enumerate(zip(batches, generator_states)):
            gen = torch.Generator(device=self.device)
            gen.set_state(gen_state)
            loss, _, outputs = self.loss_and_grads(batch, gen, start_step + k)
            losses.append(loss)
            if k == 0:
                rgb = outputs["rgb"]
                grads = {n: p.grad.detach().clone() for n, p in self.model.named_parameters() if p.grad is not None}
            self.adam(state, start_step + k, k + 1)
        after = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        return {"losses": losses, "grads": grads, "rgb": rgb, "after": after}

