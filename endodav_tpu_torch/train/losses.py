"""Self-supervised training losses.

Port of `endodav_tpu/train/losses.py:80-425`: `forward_flow_nets` (the
position, occlusion and transform nets for both source frames),
`position_phase_loss` (phase 0), `main_phase` (depth, pose, image
synthesis and the full loss) and `validation_ncc` (the score `val` logs).  The warps are batched exactly as in JAX:
one `grid_sample` launch per warp kind -- registration (img_tile over the
scales), colour synthesis (img_tile, coordinate-only backward), the
temporal depth warps (all 16 in one launch, fused backward) -- plus one
splat.  JAX's `forward_flow_nets` also returns the bidirectional flow-
consistency map (`occu_map_bidirection`); no loss reads it and jit drops
it, so the port does not compute it (`ops/sampling.flow_consistency`).

``mods`` maps the trainer's component names to modules.  Which parameters
get gradients is decided by the caller (`train/optim.set_trainable`), as
JAX's per-phase `value_and_grad`; ``.detach()`` marks the reference's
stop-gradient sites.  BatchNorm statistics of train-mode encoder calls are
recorded in the modules and committed by the trainer
(`models/resnet.commit_batch_stats`); those of the depth model (AF-SfM's
encoder, an EndoDAC head with ``use_bn``) are dropped, as JAX's
`main_phase` drops them (``disp_out, _ = _apply(...)``).

The depth model takes the clip as [B, T, H, W, 3]; a single-frame model
(EndoDAC, AF-SfM) flattens it to its B*T frames, as in JAX.  With a bf16
compute dtype the tensors promote as JAX's do: the nets' outputs come
out bf16 and the encoders' maps f32, registrations, colour synthesis and
refined images f32 (f32 source frames), occlusion masks, depths and the
flow-warped depths bf16, the learned intrinsics f32 (cast, as JAX :220),
and the loss f32.

Known reference quirk kept for parity: the temporal depth terms index the
flattened [B*T] batch with [1:]/[:-1], pairing the last frame of clip b
with the first frame of clip b+1.  All tensors are channels-last.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.geometry.losses import (abs_jax, clip_jax, ncc, reprojection_loss,
                                               smooth_loss)
from endodav_tpu_torch.geometry.transforms import (backproject_depth, disp_to_depth,
                                                   project_3d, transformation_from_parameters)
from endodav_tpu_torch.models.resnet import discard_batch_stats
from endodav_tpu_torch.ops.resize import resize2d
from endodav_tpu_torch.ops.sampling import (flow_to_grid, flow_warp, grid_sample,
                                            occlusion_mask_backward)

__all__ = ["forward_flow_nets", "position_phase_loss", "main_phase", "validation_ncc"]


def _up(x, hw):
    return resize2d(x, hw, "bilinear", align_corners=True)


def _stack_sf(out, key, scales):
    """out[(key, "high", s, f)] stacked to [2*B*n_s, H, W, C], ordered
    (frame, batch, scale) with the scale innermost: the layout
    `grid_sample(..., img_tile=n_s)` wants."""
    parts = [torch.stack([out[(key, "high", s, f)] for s in scales], dim=1).flatten(0, 1)
             for f in (-1, 1)]
    return torch.cat(parts, dim=0)


def _unstack_sf(out, key, arr, scales):
    arr = arr.reshape(2, -1, len(scales), *arr.shape[1:])
    for fi, f in enumerate((-1, 1)):
        for si, s in enumerate(scales):
            out[(key, s, f)] = arr[fi, :, si]


def forward_flow_nets(mods, batch, scales, hw, train_position: bool, train_transform: bool):
    """Position + occlusion + transform forward for both source frames
    (`forward_flow_nets`, losses.py:80-142).  Returns the outputs dict."""
    h, w = hw
    out = {}
    n_s = len(scales)
    color0_aug = batch[("color_aug", 0, 0)]
    for f in (-1, 1):
        fwd_in = torch.cat([batch[("color_aug", f, 0)], color0_aug], dim=-1)
        rev_in = torch.cat([color0_aug, batch[("color_aug", f, 0)]], dim=-1)
        pos_f = mods["position"](mods["position_encoder"](fwd_in, train_position))
        pos_r = mods["position"](mods["position_encoder"](rev_in, train_position))
        for s in scales:
            out[("position", s, f)] = pos_f[("position", s)]
            out[("position", "high", s, f)] = _up(pos_f[("position", s)], (h, w))
            out[("position_reverse", s, f)] = pos_r[("position", s)]
            out[("position_reverse", "high", s, f)] = _up(pos_r[("position", s)], (h, w))

    his = _stack_sf(out, "position", scales)            # [2*B*n_s, H, W, 2]
    hirs = _stack_sf(out, "position_reverse", scales)
    src = torch.cat([batch[("color", -1, 0)], batch[("color", 1, 0)]], dim=0)
    _unstack_sf(out, "registration", flow_warp(src, his, img_grad=False, img_tile=n_s), scales)
    masks, occ_maps = occlusion_mask_backward(hirs)
    _unstack_sf(out, "occu_mask_backward", masks, scales)
    _unstack_sf(out, "occu_map_backward", occ_maps, scales)

    color0 = batch[("color", 0, 0)]
    for f in (-1, 1):
        t_in = torch.cat([out[("registration", 0, f)], color0], dim=-1)
        trans = mods["transform"](mods["transform_encoder"](t_in, train_transform))
        for s in scales:
            out[("transform", s, f)] = trans[("transform", s)]
            hi = _up(trans[("transform", s)], (h, w))
            out[("transform", "high", s, f)] = hi
            refined = hi * out[("occu_mask_backward", 0, f)].detach() + color0
            out[("refined", s, f)] = clip_jax(refined, 0.0, 1.0)
    return out


def _stack5(key_of, scales):
    """[2, B, n_s, H, W, C] over (frame -1/+1, batch, scale)."""
    return torch.stack([torch.stack([key_of(s, f) for s in scales], dim=1) for f in (-1, 1)])


def position_phase_loss(outputs, batch, scales, position_smoothness: float,
                        use_ssim: bool = True):
    """Phase-0 loss (`position_phase_loss`, losses.py:145-176)."""
    n_s = len(scales)
    reg5 = _stack5(lambda s, f: outputs[("registration", s, f)], scales)
    ref5 = _stack5(lambda s, f: outputs[("refined", s, f)], scales).detach()
    occu5 = torch.stack([outputs[("occu_mask_backward", 0, f)] for f in (-1, 1)]).detach()[:, :, None]
    bt = reg5.shape[1]
    rep5 = reprojection_loss(reg5.flatten(0, 2), ref5.flatten(0, 2), use_ssim).reshape(
        2, bt, n_s, *reg5.shape[3:5], 1)
    l_reg_fs = (rep5 * occu5).sum(dim=(1, 3, 4, 5)) / occu5.sum(dim=(1, 3, 4, 5))  # [2, n_s]
    total = 0.0
    for si, s in enumerate(scales):
        color = batch[("color", 0, s)]
        loss_smooth = sum(smooth_loss(outputs[("position", s, f)], color) for f in (-1, 1))
        total = total + l_reg_fs[:, si].sum() / 2.0 + position_smoothness * (
            loss_smooth / 2.0) / (2 ** s)
    return total / n_s


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def main_phase(mods, batch, cfg, temporal_weight: float = 1.0):
    """Depth + pose forward, image synthesis and the full loss
    (`main_phase`, losses.py:184-423).  Returns (loss, {"losses",
    "outputs"})."""
    scales = cfg["scales"]
    h, w = cfg["height"], cfg["width"]
    use_ssim = not cfg["no_ssim"]
    train = cfg["train"]
    outputs = forward_flow_nets(mods, batch, scales, (h, w), train_position=False,
                                train_transform=train)

    video = batch[("color_aug", 0, 0)].reshape(cfg["batch_size"], cfg["T"], h, w, 3)
    disp_out = mods["depth_model"](video, train=train)
    discard_batch_stats(mods["depth_model"])
    for s in scales:
        outputs[("disp", s)] = disp_out[("disp", s)]

    for f in (-1, 1):
        pose_in = torch.cat([batch[("color_aug", f, 0)], batch[("color_aug", 0, 0)]], dim=-1)
        axisangle, translation, mid = mods["pose"]([mods["pose_encoder"](pose_in, train)[-1]])
        if cfg["learn_intrinsics"]:
            cam_K = mods["intrinsics_head"](mid, w, h).float()
            outputs[("K", 0)] = cam_K
            outputs[("inv_K", 0)] = torch.linalg.inv(cam_K)
        outputs[("axisangle", 0, f)] = axisangle
        outputs[("translation", 0, f)] = translation
        outputs[("cam_T_cam", 0, f)] = transformation_from_parameters(
            axisangle[:, 0, 0], translation[:, 0, 0])
    if cfg["learn_intrinsics"]:
        cam_K, inv_K = outputs[("K", 0)], outputs[("inv_K", 0)]
    else:
        cam_K, inv_K = batch[("K", 0)], batch[("inv_K", 0)]

    # geometry on a scale-stacked [n_s * BT] axis (losses.py:254-276)
    n_s = len(scales)
    disp_full = torch.stack([_up(outputs[("disp", s)], (h, w)) for s in scales])
    bt = disp_full.shape[1]
    _, depth_all = disp_to_depth(disp_full, cfg["min_depth"], cfg["max_depth"])
    for si, s in enumerate(scales):
        outputs[("depth", 0, s)] = depth_all[si]
    points_all = backproject_depth(depth_all.reshape(n_s * bt, h, w, 1), inv_K.repeat(n_s, 1, 1))
    pix_of, src_depth_of = {}, {}
    for f in (-1, 1):
        pix_all, srcd_all = project_3d(points_all, cam_K.repeat(n_s, 1, 1),
                                       outputs[("cam_T_cam", 0, f)].repeat(n_s, 1, 1), h, w)
        pix_of[f] = pix_all.reshape(n_s, bt, h, w, 2)
        srcd = srcd_all.reshape(n_s, bt, *srcd_all.shape[1:])
        for si, s in enumerate(scales):
            outputs[("sample", f, s)] = pix_of[f][si]
            src_depth_of[(s, f)] = srcd[si]

    # colour synthesis: one launch, source frames shared across scales
    grids = [pix_of[f].transpose(0, 1).reshape(-1, h, w, 2) for f in (-1, 1)]
    src = torch.cat([batch[("color", -1, 0)], batch[("color", 1, 0)]], dim=0)
    col5 = grid_sample(src, torch.cat(grids, dim=0), padding_mode="border", align_corners=True,
                       img_grad=False, img_tile=n_s)
    col5 = col5.reshape(2, -1, n_s, h, w, col5.shape[-1])
    for fi, f in enumerate((-1, 1)):
        for si, s in enumerate(scales):
            outputs[("color", f, s)] = col5[fi, :, si]

    # temporal depth warps: cross-frame reprojection samples and
    # flow-warped depths, all zeros-mode C=1 warps -- one launch
    dep_imgs, dep_grids, metas = [], [], []
    for s in scales:
        depth = outputs[("depth", 0, s)]
        for f in (-1, 1):
            pix = outputs[("sample", f, s)]
            dep_imgs.append(depth[1:] if f == 1 else depth[:-1])
            dep_grids.append(pix[:-1] if f == 1 else pix[1:])
            metas.append(("reproj", s, f))
    for s in scales:
        depth = outputs[("depth", 0, s)]
        for f in (-1, 1):
            hi = outputs[("position", "high", s, f)]
            dep_imgs.append(depth[:-1] if f == 1 else depth[1:])
            dep_grids.append(flow_to_grid(hi[:-1] if f == 1 else hi[1:]))
            metas.append(("flow", s, f))
    sampled_all = grid_sample(torch.cat(dep_imgs), torch.cat(dep_grids), padding_mode="zeros",
                              align_corners=True)
    for (kind, s, f), sampled in zip(metas, sampled_all.chunk(len(metas))):
        if kind == "reproj":
            src_depths = src_depth_of[(s, f)]
            src_depth = (src_depths[:-1] if f == 1 else src_depths[1:]).reshape(sampled.shape)
            outputs[("reproj_depth_error", s, f)] = _masked_mean(
                abs_jax(src_depth - sampled), sampled > 1e-3)
        else:
            depth = outputs[("depth", 0, s)]
            fwd = depth[1:] if f == 1 else depth[:-1]
            outputs[("flow_depth_error", s, f)] = _masked_mean(
                abs_jax(sampled - fwd), sampled > 1e-3)

    # losses (losses.py:344-423), batched over (frame, scale)
    refined5 = _stack5(lambda s, f: outputs[("refined", s, f)], scales)
    trans5 = _stack5(lambda s, f: outputs[("transform", "high", s, f)], scales)
    reg5 = _stack5(lambda s, f: outputs[("registration", s, f)], scales).detach()
    reg0_5 = torch.stack([outputs[("registration", 0, f)] for f in (-1, 1)]).detach()[:, :, None]
    occu5 = torch.stack([outputs[("occu_mask_backward", 0, f)] for f in (-1, 1)]).detach()[:, :, None]
    nb = col5.shape[1]
    rep5 = reprojection_loss(col5.flatten(0, 2), refined5.flatten(0, 2), use_ssim).reshape(
        2, nb, n_s, h, w, 1)
    red = (1, 3, 4, 5)
    occ_den = occu5.sum(dim=red)                                          # [2, 1]
    l_rep_fs = (rep5 * occu5).sum(dim=red) / occ_den                      # [2, n_s]
    l_trans_fs = (abs_jax(refined5 - reg0_5).mean(-1, keepdim=True) * occu5).sum(dim=red) / occ_den
    residue = batch[("color", 0, 0)][None, :, None] - reg5
    gtx = abs_jax(trans5[..., :, :-1, :] - trans5[..., :, 1:, :]).mean(-1, keepdim=True)
    gty = abs_jax(trans5[..., :-1, :, :] - trans5[..., 1:, :, :]).mean(-1, keepdim=True)
    grx = abs_jax(residue[..., :, :-1, :] - residue[..., :, 1:, :]).mean(-1, keepdim=True)
    gry = abs_jax(residue[..., :-1, :, :] - residue[..., 1:, :, :]).mean(-1, keepdim=True)
    mask_x, mask_y = occu5[..., :, :-1, :], occu5[..., :-1, :, :]
    l_cvt_fs = ((gtx * torch.exp(-grx) * mask_x).sum(dim=red) / mask_x.sum(dim=red)
                + (gty * torch.exp(-gry) * mask_y).sum(dim=red) / mask_y.sum(dim=red))

    losses = {}
    total = 0.0
    for si, s in enumerate(scales):
        color = batch[("color", 0, s)]
        disp = outputs[("disp", s)]
        if disp.shape[1:3] != color.shape[1:3]:
            disp = _up(disp, tuple(color.shape[1:3]))
        l_dr = outputs[("reproj_depth_error", s, -1)] + outputs[("reproj_depth_error", s, 1)]
        l_df = outputs[("flow_depth_error", s, -1)] + outputs[("flow_depth_error", s, 1)]
        mean_disp = disp.mean(dim=(1, 2), keepdim=True)
        l_smooth = smooth_loss(disp / (mean_disp + 1e-7), color)
        l_rep = l_rep_fs[:, si].sum() / 2.0
        l_trans = cfg["transform_constraint"] * l_trans_fs[:, si].sum() / 2.0
        l_cvt = cfg["transform_smoothness"] * l_cvt_fs[:, si].sum() / 2.0
        l_smooth = cfg["disparity_smoothness"] * l_smooth / (2 ** s)
        l_dr = temporal_weight * cfg["depth_reproj"] * l_dr / 2.0
        l_df = temporal_weight * cfg["depth_flow"] * l_df / 2.0
        scale_loss = l_rep + l_trans + l_cvt + l_smooth + l_dr + l_df
        total = total + scale_loss
        losses[f"loss/{s}"] = scale_loss
        losses[f"loss/loss_reprojection/{s}"] = l_rep
        losses[f"loss/loss_transform/{s}"] = l_trans
        losses[f"loss/loss_cvt/{s}"] = l_cvt
        losses[f"loss/loss_smooth/{s}"] = l_smooth
        losses[f"loss/loss_depth_reproj/{s}"] = l_dr
        losses[f"loss/loss_depth_flow/{s}"] = l_df
    total = total / n_s
    losses["loss"] = total
    return total, {"losses": losses, "outputs": outputs}


def validation_ncc(outputs, batch, scales):
    """The NCC registration score of a val batch (`validation_ncc`,
    losses.py:426-438): per scale, the better (lower) of the two source
    frames' negative NCC against frame 0, averaged; negated."""
    target = batch[("color", 0, 0)].mean(dim=-1, keepdim=True)
    total = 0.0
    for s in scales:
        regs = [ncc(outputs[("registration", s, f)].mean(dim=-1, keepdim=True), target)
                for f in (-1, 1)]
        total = total + torch.cat(regs, dim=-1).amin(dim=-1).mean()
    return -(total / len(scales))
