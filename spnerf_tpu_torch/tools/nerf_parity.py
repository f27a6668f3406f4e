"""Where the full-width NeRF's results on the card part from the CPU's:
each stage of ``models.nerf.render_rays`` run on both devices from the
same inputs (the CPU's output of the stage before), with the largest
distance and the share of equal values.

    python -m spnerf_tpu_torch.tools.nerf_parity [--rays 256] [--seed 34]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.models import nerf as tn


def _report(name: str, card: torch.Tensor, cpu: torch.Tensor) -> None:
    card, cpu = card.detach().cpu().float(), cpu.detach().float()
    print(f"{name:28s} max {float((card - cpu).abs().max()):.3e}  equal "
          f"{float((card == cpu).float().mean()):.4f}  scale "
          f"{float(cpu.abs().max()):.3e}", flush=True)


@torch.no_grad()
def stages(n_rays: int = 256, seed: int = 34) -> None:
    dev = resolve_device("cuda")
    on = lambda t: t.to(dev)  # noqa: E731
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (n_rays, 3)).astype(np.float32))
    d = F.normalize(torch.from_numpy(
        rng.standard_normal((n_rays, 3)).astype(np.float32)), dim=-1)
    cfg = tn.NeRFConfig(near=0.5, far=4.5)
    u_c, u_f = tn.draw_ray_uniforms(n_rays, cfg,
                                    torch.Generator().manual_seed(seed), "cpu")
    cpu_model = tn.init_nerf(seed, cfg, device="cpu")
    card_model = tn.NeRF(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    card_model.to(dev)

    t_c = tn.stratified_samples(cfg.n_coarse, cfg.near, cfg.far, (n_rays,),
                                u=u_c)
    _report("stratified samples", tn.stratified_samples(
        cfg.n_coarse, cfg.near, cfg.far, (n_rays,), u=on(u_c), device=dev), t_c)
    args = tn.ray_point_arguments(o, d, t_c, cfg.pos_freqs)
    _report("encoding arguments", tn.ray_point_arguments(
        on(o), on(d), on(t_c), cfg.pos_freqs), args)
    _report("sin of the arguments", torch.sin(on(args)), torch.sin(args))
    enc = tn._finish_encoding(args, 3)
    dir_enc = tn.positional_encoding(d, cfg.dir_freqs)[:, None, :].expand(
        n_rays, cfg.n_coarse, 3 + 6 * cfg.dir_freqs)
    sigma, rgb = cpu_model.encoded(enc, dir_enc, "coarse")
    card_sigma, card_rgb = card_model.encoded(on(enc), on(dir_enc), "coarse")
    _report("coarse sigma", card_sigma, sigma)
    _report("coarse rgb", card_rgb, rgb)
    w = tn.render_weights(sigma, t_c)
    _report("render_weights", tn.render_weights(on(sigma), on(t_c)), w)
    _report("pdf_cdf", tn.pdf_cdf(on(w)), tn.pdf_cdf(w))
    edges = torch.cat([t_c[..., :1], 0.5 * (t_c[..., 1:] + t_c[..., :-1]),
                       t_c[..., -1:]], dim=-1)
    _report("sample_pdf", tn.sample_pdf(on(edges), on(w), cfg.n_fine,
                                        u=on(u_f)),
            tn.sample_pdf(edges, w, cfg.n_fine, u=u_f))
    want = tn.render_rays(cpu_model, o, d, cfg, draws=(u_c, u_f))
    got = tn.render_rays(card_model, on(o), on(d), cfg,
                         draws=(on(u_c), on(u_f)))
    for key, value in want.items():
        _report(f"render_rays {key}", got[key], value)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rays", type=int, default=256)
    p.add_argument("--seed", type=int, default=34)
    args = p.parse_args(argv)
    print(torch.cuda.get_device_name(0) if torch.cuda.is_available()
          else "no CUDA device", flush=True)
    stages(args.rays, args.seed)


if __name__ == "__main__":
    main()
