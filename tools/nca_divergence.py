"""Does maua_tpu's texture-NCA recipe diverge at the settings of chip_smoke.py's `nca` phase, and does
the port follow it there? On the CPU; imports both packages (the port's chip phase cannot replay JAX's
draws, so this is the reference for it).

    JAX_PLATFORMS=cpu python tools/nca_divergence.py [--size 128] [--steps 20] [--seed 0]

1. maua_tpu's `train_nca`, unchanged, at its defaults (batch 4, rollouts of 32-63 steps, pool 256, lr
   2e-3, PRNGKey(seed)) on chip_smoke's style image (`write_style_image(..., size, seed=9)`): its own log
   (one line every steps // 10 steps) and whether its trained params are finite.
2. The port's `train_nca` on the same image, initial params, VGG16 weights (maua_tpu's PRNGKey(0) draw)
   and draws (maua_tpu's split keys replayed): each step's loss, the largest magnitude of its rolled-out
   states and the share of their rgb clipped at +-1.

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from chip_smoke import write_style_image
    from maua_tpu.nca import nca as J
    from maua_tpu.perceptors import vgg as JVGG
    from maua_tpu_torch import bridge
    from maua_tpu_torch.nca import nca as T
    from maua_tpu_torch.ops.io import load_image
    from maua_tpu_torch.perceptors.vgg import VGGPerceptor

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "style.png")
        write_style_image(path, args.size, seed=9)
        style = load_image(path) * 2.0 - 1.0
    kw = dict(n_steps=args.steps, rollout_steps=(32, 64), batch=4, size=args.size, pool_size=256)
    key = jax.random.PRNGKey(args.seed)

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        want = J.train_nca(jnp.asarray(style), key=key, verbose=True, **kw)
    ref_seconds = time.perf_counter() - t0
    ref_losses = {int(m[1]): float(m[2]) for m in re.finditer(r"nca step (\d+)/\d+ loss (\S+)", log.getvalue())}

    def draws(i, k=[key]):  # maua_tpu's loop: key, k1, k2, k3 = split(key, 4) each step
        assert i == len(ref_draws)
        k[0], k1, k2, k3 = jax.random.split(k[0], 4)
        idx = np.asarray(jax.random.choice(k1, kw["pool_size"], (kw["batch"],), replace=False))
        n_roll = int(jax.random.randint(k2, (), *kw["rollout_steps"]))
        masks = np.stack([np.asarray(jax.random.uniform(kk, (kw["batch"], args.size, args.size, 1)))
                          for kk in jax.random.split(k3, n_roll)])
        ref_draws.append(n_roll)
        return idx, n_roll, torch.from_numpy(masks)

    ref_draws = []
    vgg = jax.tree_util.tree_map(np.asarray, JVGG.init_params(jax.random.PRNGKey(0), "vgg16"))
    percept = VGGPerceptor(arch="vgg16", params=bridge.guidance_params_to_torch(vgg), device="cpu")
    params = bridge.nca_params_to_torch(jax.tree_util.tree_map(np.asarray, J.init_params(key, 12, 96)))
    stats = {}
    t0 = time.perf_counter()
    got = T.train_nca(torch.from_numpy(np.asarray(style)), params=params, perceptor=percept, draws=draws,
                      device="cpu", stats=stats, verbose=False, **kw)
    port_seconds = time.perf_counter() - t0

    def first(flags):
        return next((i for i, f in enumerate(flags) if f), None)

    losses = stats["losses"]
    both = {i: (v, losses[i]) for i, v in ref_losses.items()}
    finite_pairs = [(a, b) for a, b in both.values() if math.isfinite(a) and math.isfinite(b)]
    print(json.dumps({
        "size": args.size, "steps": args.steps, "seed": args.seed, "rollouts": stats["rollouts"],
        "maua_tpu": {"logged_losses": ref_losses, "params_finite": bool(all(np.isfinite(np.asarray(v)).all()
                                                                            for v in want.values())),
                     "seconds": ref_seconds},
        "port": {"losses": losses, "state_peaks": stats["state_peaks"], "clipped": stats["clipped"],
                 "params_finite": bool(all(torch.isfinite(v).all() for v in got.values())),
                 "seconds": port_seconds},
        "first_nonfinite_loss": {"maua_tpu_logged": next((i for i in sorted(ref_losses)
                                                          if not math.isfinite(ref_losses[i])), None),
                                 "port": first(not math.isfinite(v) for v in losses)},
        "first_step_clipped_over_half": first(c > 0.5 for c in stats["clipped"]),
        "logged_losses_max_rel_diff": max((abs(a - b) / max(abs(a), 1e-12) for a, b in finite_pairs), default=None),
        "same_nonfinite_logged_steps": all(math.isfinite(a) == math.isfinite(b) for a, b in both.values()),
    }))


if __name__ == "__main__":
    main()
