"""SmallBlurryImage (SBI): blurred frame thumbnails, ESM SE(2) alignment,
and the SE(2) -> SE(3) rotation lift.

Port of the JAX package's ``ops/sbi.py`` (the reference's
jni/SmallBlurryImage.{h,cc}): template construction (MakeFromKF :20-55),
gradient jacobians (MakeJacs :58-78), the zero-mean SSD score
(ZMSSD :82-94) and its batched form against every keyframe
(Relocaliser::ScoreKFs, jni/Relocaliser.cc:46-58), 4-DoF ESM alignment
(IteratePosRelToTarget :99-222) and SE3fromSE2 (:245-333). The per-pixel
loops are whole-image masked reductions; the fixed-count iterations are
Python loops.
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import image as img_ops
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.utils.tensors import TensorTree, const


@dataclasses.dataclass(frozen=True)
class SBI(TensorTree):
    template: torch.Tensor  # [h, w] zero-mean blurred f32
    jacs: torch.Tensor      # [h, w, 2] (gx, gy) gradients of template


def make_template(level3_img, blur_sigma=0.75):
    """Half-sample pyramid level 3, subtract the mean, blur with the
    reference's fixed 9x9 kernel (SmallBlurryImage.cc:20-55)."""
    small = img_ops.half_sample(level3_img)
    tmpl = small - torch.mean(small)
    return img_ops.separable_blur(
        tmpl, img_ops.blur_kernel(blur_sigma, 4, tmpl)
    )


def _interior(h, w, device):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (xs >= 1) & (xs < w - 1) & (ys >= 1) & (ys < h - 1)


def make_jacs(template):
    """Central differences without the 1/2 factor, zero on the 1-px
    border (MakeJacs, SmallBlurryImage.cc:58-78)."""
    h, w = template.shape
    gx = torch.zeros_like(template)
    gx[:, 1:-1] = template[:, 2:] - template[:, :-2]
    gy = torch.zeros_like(template)
    gy[1:-1, :] = template[2:, :] - template[:-2, :]
    interior = _interior(h, w, template.device)
    return torch.stack(
        [torch.where(interior, gx, 0.0), torch.where(interior, gy, 0.0)],
        dim=-1,
    )


def make_sbi(level3_img, blur_sigma=0.75) -> SBI:
    tmpl = make_template(level3_img, blur_sigma)
    return SBI(template=tmpl, jacs=make_jacs(tmpl))


def zmssd(a_template, b_template):
    """Plain SSD of zero-mean templates (SmallBlurryImage.cc:82-94),
    batched over leading axes."""
    d = a_template - b_template
    return torch.sum(d * d, dim=(-2, -1))


def score_against_all(cur_template, kf_templates, kf_valid):
    """ZMSSD of the current SBI against every keyframe SBI at once (the
    batched Relocaliser::ScoreKFs, jni/Relocaliser.cc:46-58). Invalid
    slots score +inf."""
    scores = zmssd(kf_templates, cur_template[None])
    return torch.where(kf_valid, scores, torch.inf)


_OUT_OF_IMAGE = -9e20


def esm_align(cur_template, target: SBI, n_iterations=6):
    """Align `cur_template` to `target` with 4-DoF ESM
    (IteratePosRelToTarget, SmallBlurryImage.cc:99-222). Returns
    (se2 [3] = [tx, ty, theta] of the warp about the image center,
    final score); the mean offset is estimated internally."""
    h, w = cur_template.shape
    dtype, device = cur_template.dtype, cur_template.device
    center = const((w / 2.0, h / 2.0), device, dtype)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device),
        indexing="ij",
    )
    ysf, xsf = ys.to(dtype), xs.to(dtype)
    grid = torch.stack([xsf, ysf], dim=-1)  # [h, w, 2] (x, y)
    interior = _interior(h, w, device)
    eye4 = 1e-8 * torch.eye(4, dtype=dtype, device=device)
    tj = target.jacs

    se2 = torch.zeros(3, dtype=dtype, device=device)
    mean_offset = torch.zeros((), dtype=dtype, device=device)
    score = torch.zeros((), dtype=dtype, device=device)
    for _ in range(n_iterations):
        Rc, tc = lie.se2_exp(se2)
        t_x = tc + center - Rc @ center
        src = t_x + grid @ Rc.T
        src_ok = (
            (src[..., 0] >= 0) & (src[..., 1] >= 0)
            & (src[..., 0] < w - 1) & (src[..., 1] < h - 1)
        )
        warped = torch.where(
            src_ok, img_ops.bilinear_sample(cur_template, src), _OUT_OF_IMAGE
        )
        # A pixel participates if it and its 4-neighbors are in-warp (the
        # reference's l+r+u+d+here < -9999.9 check, :160-165).
        left = torch.roll(warped, 1, dims=1)
        right = torch.roll(warped, -1, dims=1)
        up = torch.roll(warped, 1, dims=0)
        down = torch.roll(warped, -1, dims=0)
        nsum = warped + left + right + up + down
        valid = interior & (nsum > -9999.9)

        gx = 0.25 * ((right - left) + tj[..., 0])
        gy = 0.25 * ((down - up) + tj[..., 1])
        jac_rot = -(ysf - center[1]) * gx + (xsf - center[0]) * gy
        J = torch.stack([gx, gy, jac_rot, torch.ones_like(gx)], dim=-1)

        diff = warped - target.template + mean_offset
        vf = valid.to(dtype)
        score = torch.sum(vf * diff * diff)
        Jv = (J * vf[..., None]).reshape(-1, 4)
        JTJ = Jv.T @ J.reshape(-1, 4)
        JTe = Jv.T @ diff.reshape(-1)
        update = torch.linalg.solve_ex(JTJ + eye4, JTe)[0]

        Ru, tu = lie.se2_exp(-update[:3])
        Rc2, tc2 = lie.se2_mul(Rc, tc, Ru, tu)
        se2 = lie.se2_ln(Rc2, tc2)
        mean_offset = mean_offset - update[3]
    return se2, score


def se3_from_se2(se2, cam_full: cam_ops.Camera, sbi_shape):
    """Lift an SBI-plane SE(2) to a camera rotation (SE3fromSE2,
    SmallBlurryImage.cc:245-333): two points +/-5 px about the center, 3
    WLS iterations on SO(3) with prior 10. Returns (R [3, 3], t = 0)."""
    h, w = sbi_shape
    dtype, device = se2.dtype, se2.device
    cam = cam_ops.scale_camera(cam_full, w / cam_full.size[0])
    center = const((w / 2.0, h / 2.0), device, dtype)
    pts = const(((5.0, 0.0), (-5.0, 0.0)), device, dtype)
    R2, t2 = lie.se2_exp(se2)
    turned = center + pts @ R2.T + t2  # [2, 2]
    m_orig = cam_ops.unproject(cam, center + pts)
    p3 = torch.cat([m_orig, torch.ones(2, 1, dtype=dtype, device=device)], -1)
    prior = 10.0 * torch.eye(3, dtype=dtype, device=device)

    R = torch.eye(3, dtype=dtype, device=device)
    for _ in range(3):
        pc = p3 @ R.T  # [2, 3]
        m = pc[:, :2] / pc[:, 2:3]
        px, Jpx = cam_ops.project_derivs(cam, m)
        err = (turned - px).reshape(-1)  # [4]
        inv_z = 1.0 / pc[:, 2]
        pc_h = torch.cat([pc, torch.ones(2, 1, dtype=dtype, device=device)], -1)
        rows = []
        for g_idx in range(3):
            gen = lie.se3_generator_field(pc_h, 3 + g_idx)[:, :3]  # [2, 3]
            dm = torch.stack(
                [(gen[:, 0] - pc[:, 0] * gen[:, 2] * inv_z) * inv_z,
                 (gen[:, 1] - pc[:, 1] * gen[:, 2] * inv_z) * inv_z],
                dim=-1,
            )  # [2, 2]
            rows.append((Jpx @ dm[..., None])[..., 0].reshape(-1))  # [4]
        J = torch.stack(rows, dim=-1)  # [4, 3]
        res = torch.linalg.solve_ex(J.T @ J + prior, J.T @ err)[0]
        R = lie.so3_exp(res) @ R
    return R, torch.zeros(3, dtype=dtype, device=device)
