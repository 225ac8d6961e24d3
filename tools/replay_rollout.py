#!/usr/bin/env python
"""Replay an ``export_rollout`` .npz in MuJoCo — the reference's
``visualize_policy`` capability (reference: mjrl/utils/gym_env.py
``visualize_policy``) restored for a policy trained on device.

``mjrl_tpu.utils.evaluation.export_rollout`` saves the raw qpos trajectory;
since the locomotion envs are compiled from the vendored Gymnasium MuJoCo assets,
those same XMLs replay the trajectory bit-for-bit as a kinematic animation:

    python tools/replay_rollout.py rollout.npz --env hopper --view
    python tools/replay_rollout.py rollout.npz --env ant --frames out/ --fps 25
    python tools/replay_rollout.py rollout.npz --xml my_model.xml --video out.mp4

``--view`` opens the interactive mujoco.viewer (needs a display);
``--frames`` renders offscreen PNGs (works headless, EGL/OSMesa);
``--video`` writes an mp4 if imageio+ffmpeg are available, else falls back
to frames.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_ASSETS = {
    "hopper": "hopper.xml",
    "walker2d": "walker2d.xml",
    "half_cheetah": "half_cheetah.xml",
    "swimmer": "swimmer.xml",
    "ant": "ant.xml",
    "humanoid": "humanoid.xml",
    "inverted_pendulum": "inverted_pendulum.xml",
}


def _resolve_xml(args) -> str:
    if args.xml:
        return args.xml
    if not args.env:
        sys.exit("need --env <name> or --xml <path>")
    name = args.env
    if name in _ASSETS:
        from mjrl_tpu.envs.locomotion import _asset_path

        return _asset_path(_ASSETS[name])
    if name.startswith("adroit_"):
        try:
            import gymnasium_robotics
        except ImportError:
            sys.exit("adroit replay needs gymnasium_robotics assets")
        task = name.split("_", 1)[1]
        return os.path.join(
            os.path.dirname(gymnasium_robotics.__file__),
            "envs",
            "adroit_hand",
            "assets",
            f"adroit_{task}.xml",
        )
    sys.exit(f"unknown env {name!r}; pass --xml")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("rollout", help=".npz from export_rollout")
    p.add_argument("--env", default=None, help="env name (hopper, ant, ...)")
    p.add_argument("--xml", default=None, help="explicit MJCF path")
    p.add_argument("--view", action="store_true", help="interactive viewer")
    p.add_argument("--frames", default=None, help="directory for PNG frames")
    p.add_argument("--video", default=None, help="mp4 output path")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--stride", type=int, default=0,
                   help="frame stride (default: match --fps to env dt)")
    args = p.parse_args()

    import mujoco

    data = np.load(args.rollout)
    if "qpos" not in data:
        sys.exit("rollout has no qpos track (analytic env?) — nothing to replay")
    qpos = data["qpos"]
    print(f"{args.rollout}: {qpos.shape[0]} frames, nq={qpos.shape[1]}, "
          f"return={float(np.sum(data['rewards'])):.1f}")

    xml = _resolve_xml(args)
    model = mujoco.MjModel.from_xml_path(xml)
    if model.nq != qpos.shape[1]:
        sys.exit(f"nq mismatch: rollout {qpos.shape[1]} vs {xml} {model.nq}")
    mjdata = mujoco.MjData(model)
    # control timestep of the recording = model dt * frame_skip; the npz is
    # one row per control step, so replay at that cadence
    dt_ctrl = model.opt.timestep * max(
        1, int(round((1.0 / args.fps) / model.opt.timestep))
    )

    if args.view:
        import mujoco.viewer

        with mujoco.viewer.launch_passive(model, mjdata) as viewer:
            while viewer.is_running():
                for t in range(qpos.shape[0]):
                    mjdata.qpos[:] = qpos[t]
                    mujoco.mj_forward(model, mjdata)
                    viewer.sync()
                    time.sleep(dt_ctrl)
                    if not viewer.is_running():
                        break
        return

    stride = args.stride or 1
    frames_dir = args.frames
    writer = None
    if args.video:
        try:
            import imageio.v2 as imageio

            writer = imageio.get_writer(args.video, fps=args.fps)
        except Exception as e:  # pragma: no cover - optional dep
            print(f"imageio unavailable ({e}); falling back to --frames")
            frames_dir = args.frames or os.path.splitext(args.video)[0] + "_frames"
    if writer is None and frames_dir is None:
        frames_dir = os.path.splitext(args.rollout)[0] + "_frames"
    if frames_dir:
        os.makedirs(frames_dir, exist_ok=True)

    renderer = mujoco.Renderer(model, height=args.height, width=args.width)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    n_out = 0
    for t in range(0, qpos.shape[0], stride):
        mjdata.qpos[:] = qpos[t]
        mujoco.mj_forward(model, mjdata)
        renderer.update_scene(mjdata)
        px = renderer.render()
        if writer is not None:
            writer.append_data(px)
        else:
            fn = os.path.join(frames_dir, f"frame_{t:05d}.png")
            if Image is not None:
                Image.fromarray(px).save(fn)
            else:
                np.save(fn.replace(".png", ".npy"), px)
        n_out += 1
    if writer is not None:
        writer.close()
        print(f"wrote {args.video} ({n_out} frames)")
    else:
        print(f"wrote {n_out} frames to {frames_dir}/")


if __name__ == "__main__":
    main()
