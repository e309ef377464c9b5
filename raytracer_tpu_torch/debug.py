"""Single-ray debug probe: trace one pixel and narrate each bounce.

Counterpart of ``raytracer_tpu/debug.py`` (the reference's click-to-debug
``debug_cast``, src/raytracer.cu:91-100, src/main.cc:181-186).  The probe
casts through the configured engine's ``make_cast``, so on the card it runs
the CUDA kernels on 1-ray batches (and ``engine="torch"`` their plain
versions), and prints each level's cast result, each light's shadow march,
the shading contribution and the spawned rays, in the JAX package's words
and order.  Its recursion is an explicit per-ray tree walk, independent of
the wavefront (``engine.radiance``), so the tests use it as a second
opinion on the queue disciplines.
"""

from __future__ import annotations

import numpy as np
import torch

from . import raymath as rm
from .render.cast import hit_shading_attrs
from .render.engine import make_cast, trans_attenuation
from .render.geometry import camera_rays, expand_geometry
from .render.shading import gather_material_rows, illuminate
from .scene import Camera, RenderConfig, Scene


def _np(x) -> np.ndarray:
    """The first row of a 1-ray tensor, as numpy."""
    return x.detach().cpu().numpy()[0]


def _narrate_shadow_march(scene, geom, cast, cfg, origin, dir_unit, max_t,
                          label):
    """One light's shadow march, narrated step by step (the reference's
    printfs in ``attenuate``, src/rayprimitives/light.cu:38-40), with
    ``shading.march_transmissive``'s rules: a blocker beyond the light
    leaves it lit, an opaque one shadows it, a transmissive one passes it
    on, attenuated by ``Kt^t`` where the ray leaves the blocker."""
    mats = scene.materials
    cur_o = origin + rm.THRESHOLD * dir_unit
    remaining = float(max_t)
    atten = np.ones(4, np.float32)
    steps = max(1, cfg.shadow_steps)
    for step in range(steps):
        hit = cast(cur_o, dir_unit)
        if not bool(hit.valid[0]):
            print(f"    [{label}] shadow ray escaped after {step} blockers "
                  f"-> lit (atten={atten})")
            return
        t = float(hit.t[0])
        normal, mat_idx, inst = hit_shading_attrs(geom, hit)
        mat = int(mat_idx[0])
        print(f"    [{label}] shadow ray hit inst={int(inst[0])} "
              f"mat={mat} at t={t:.6f}")
        if t > remaining:
            print(f"    [{label}] blocker beyond the light "
                  f"(t > {remaining:.6f}) -> lit")
            return
        kt = mats.kt[mat].cpu().numpy()
        if not (kt > 0).any():
            print(f"    [{label}] opaque blocker -> shadowed")
            return
        exiting = float(rm.dot(normal, dir_unit)[0]) > 0.0
        if exiting:
            atten = atten * kt ** t
            print(f"    [{label}] exiting transmissive medium: "
                  f"atten *= Kt^{t:.4f} -> {atten}")
        else:
            print(f"    [{label}] entering transmissive blocker — "
                  f"continuing the march")
        cur_o = cur_o + t * dir_unit
        remaining -= t
    print(f"    [{label}] march budget ({steps} steps) exhausted "
          f"(shadow_steps)")


@torch.no_grad()
def debug_cast(scene: Scene, camera: Camera, cfg: RenderConfig, x: int,
               y: int):
    """Trace pixel ``(x, y)`` verbosely.  Returns ``(records, color)``: one
    record per ray cast (keys ``level``, ``kind``, ``o``, ``d``, ``hit``,
    ``t``, and on a hit ``inst``, ``mat``, ``normal``, ``contribution``)
    and the pixel's colour, clamped to 1 (numpy [4])."""
    geom = expand_geometry(scene)
    cast = make_cast(scene, geom, cfg)
    ro, rd = camera_rays(camera, cfg.width, cfg.height)
    o = ro[y, x][None]
    d = rd[y, x][None]
    mats = scene.materials
    lights = scene.lights
    dev = o.device

    records = []
    items = [dict(o=o, d=d, atten=torch.ones(1, 4, device=dev),
                  in_obj=torch.zeros(1, dtype=torch.bool, device=dev),
                  active=torch.ones(1, dtype=torch.bool, device=dev),
                  kind="primary")]
    total = np.zeros(4, dtype=np.float32)
    for level in range(cfg.recurse_depth + 1):
        nxt = []
        for it in items:
            if not bool(it["active"][0]):
                continue
            print(f"[level {level}] shooting a {it['kind']} ray "
                  f"o={_np(it['o'])} d={_np(it['d'])}")
            hit = cast(it["o"], it["d"])
            rec = dict(level=level, kind=it["kind"], o=_np(it["o"]),
                       d=_np(it["d"]), hit=bool(hit.valid[0]),
                       t=float(hit.t[0]))
            if not rec["hit"]:
                print("  miss")
                records.append(rec)
                continue
            normal, mat_idx, inst = hit_shading_attrs(geom, hit)
            rmats = gather_material_rows(mats, mat_idx)
            kt = rmats.kt
            kr = rmats.kr
            atten_eff = torch.where(
                it["in_obj"][:, None],
                it["atten"] * trans_attenuation(kt, hit.t), it["atten"])
            hit_pt = it["o"] + hit.t[:, None] * it["d"]
            for li in range(lights.point_pos.shape[0]):
                disp = lights.point_pos[li] - hit_pt
                _narrate_shadow_march(
                    scene, geom, cast, cfg, hit_pt, rm.normalize(disp),
                    float(rm.norm(disp)[0]), f"point light {li}")
            for li in range(lights.dir_dir.shape[0]):
                mdir = rm.normalize(-lights.dir_dir[li])[None, :]
                _narrate_shadow_march(scene, geom, cast, cfg, hit_pt, mdir,
                                      np.inf, f"dir light {li}")
            lum = illuminate(scene, geom, cast, cfg, it["o"], it["d"], hit,
                             normal, rmats, hit.valid)
            contrib = _np(atten_eff * lum)
            total += contrib
            rec.update(inst=int(inst[0]), mat=int(mat_idx[0]),
                       normal=_np(normal), contribution=contrib)
            print(f"  hit inst={rec['inst']} mat={rec['mat']} "
                  f"t={rec['t']:.6f} n={rec['normal']}")
            print(f"  contribution={contrib}")
            records.append(rec)

            if level < cfg.recurse_depth:
                if bool((kr > 0).any()):
                    print("  preparing to shoot a reflection ray")
                    nxt.append(dict(
                        o=hit_pt, d=rm.normalize(rm.reflect(it["d"], normal)),
                        atten=atten_eff * kr, in_obj=it["in_obj"],
                        active=hit.valid & (kr > 0).any(-1),
                        kind="reflection"))
                if bool((kt > 0).any()):
                    eta = rmats.eta
                    n1 = torch.where(it["in_obj"], eta, 1.0)
                    n2 = torch.where(it["in_obj"], 1.0, eta)
                    refr_d, tir = rm.refract(it["d"], normal, n1, n2)
                    if bool(tir[0]):
                        print("  total internal reflection — dropping "
                              "refraction")
                    else:
                        print("  preparing to shoot a refraction ray")
                        nxt.append(dict(
                            o=hit_pt, d=rm.normalize(refr_d), atten=atten_eff,
                            in_obj=~it["in_obj"], active=hit.valid & ~tir,
                            kind="refraction"))
        items = nxt
    color = np.minimum(total, 1.0)
    print(f"pixel ({x}, {y}) final color: {color}")
    return records, color
