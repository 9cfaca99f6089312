#!/usr/bin/env python
"""Smoke run of the SLAM pipeline on one GPU, through the CLI a user calls.

    python chip_smoke.py              # phases (a)-(d) on one GPU
    python chip_smoke.py --four-cards # the four-GPU path and its references

Phases, all in this one process (a second JAX process could not get the
card's memory):

  (a) corridor: `cli run` on configs/corridor.yaml, the 2-D FastSLAM scan;
      ATE beside its dead-reckoning control.
  (b) KITTI 00 at the preset's full width (P=2048 particles, L=10240
      landmark slots, Z=128 observations, 376x1241 stereo, 512 features,
      FastSLAM 2.0 with weight shaping): `cli synth --kind kitti`, then
      `cli run`; ATE beside dead reckoning.
  (c) BA: a two-session EuRoC run (`cli synth --kind euroc`, `cli run` on
      configs/euroc_mh.yaml) ending in the joint bundle adjustment; the
      cost of every LM iteration, which must be finite and end lower.
  (d) parity: the GPU-marked tests (the score kernel against its XLA
      reference at KITTI width, each camera model) and the resampling
      gather's achieved bandwidth.

--four-cards runs instead the multi-device equivalence checks of
`__graft_entry__.dryrun_multichip(4)` and a few panoramic frames on the
preset's 2x2 mesh ending in the distributed BA.

Each phase prints its compile seconds (tracing, lowering and XLA compile,
persistent-cache reads included) apart from the rest of its wall time. A
failed phase makes the exit code non-zero; the last line, a JSON object
with "ok": true and the device, is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SYNTH = ROOT / "data_synth"  # listed in .gitignore


class CompileClock:
    """Sums JAX's tracing, lowering and backend-compile durations."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _finite(*xs):
    return all(x is not None and math.isfinite(x) for x in xs)


def phase_corridor(cli):
    r = cli.main(["run", "--config", "configs/corridor.yaml"])
    print(f"  corridor: ATE {r['ate']:.4f} m, dead reckoning {r['ate_dr']:.4f} m")
    _check(_finite(r["ate"], r["ate_dr"]), "corridor ATE not finite")


def phase_kitti(cli, frames):
    out = SYNTH / f"kitti_smoke_{frames}"
    seq = out / "sequences" / "00"
    if not (seq / "times.txt").exists():
        cli.main(["synth", "--kind", "kitti", "--steps", str(frames), "--out", str(out)])
    r = cli.main([
        "run", "--config", "configs/kitti_00.yaml",
        "--set", f"data.path={seq}", "--frames", str(frames),
    ])
    print(f"  kitti_00: {r['frames']} frames, {r['keyframes']} keyframes, "
          f"ATE {r.get('ate')} m (online {r.get('ate_online')}), "
          f"dead reckoning {r.get('ate_dr')} m")
    _check(_finite(r.get("ate"), r.get("ate_dr")), "KITTI ATE not finite")


def phase_ba(cli, frames):
    out = SYNTH / f"euroc_smoke_{frames}"
    if not (out / "MH02" / "mav0" / "cam0" / "data.csv").exists():
        cli.main([
            "synth", "--kind", "euroc", "--sessions", "2",
            "--steps", str(frames), "--out", str(out),
        ])
    r = cli.main(["run", "--config", "configs/euroc_mh.yaml", "--set", f"data.path={out}"])
    costs = r.get("ba_costs")
    _check(costs is not None, "the EuRoC run built no BA problem")
    print("  BA cost per LM iteration: " + " ".join(f"{c:.6g}" for c in costs))
    _check(all(math.isfinite(c) for c in costs), "BA cost not finite")
    _check(costs[-1] < costs[0], f"BA cost did not decrease: {costs[0]} -> {costs[-1]}")


def phase_parity():
    import pytest

    from parakeet_slam_tpu.eval import bench_kernels

    class Count:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                setattr(self, report.outcome, getattr(self, report.outcome) + 1)

    count = Count()
    rc = pytest.main(
        ["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider", "tests/test_score_kernel.py"],
        plugins=[count],
    )
    print(f"  gpu tests: {count.passed} passed, {count.failed} failed, "
          f"{count.skipped} skipped (pytest exit {rc})")
    _check(rc == 0 and count.passed >= 3 and not count.skipped, "GPU parity tests failed")
    dt, nbytes, _ = bench_kernels.bench_resample()
    print(f"  resample gather (jnp.take) at KITTI width: {dt * 1e3:.3f} ms, "
          f"{nbytes / 1e9:.3f} GB moved, {nbytes / dt / 1e9:.1f} GB/s")


def phase_four_cards(cli):
    import jax
    import numpy as np

    import __graft_entry__
    from parakeet_slam_tpu.core.config import load_config
    from parakeet_slam_tpu.data.panoramic import make_panoramic_world
    from parakeet_slam_tpu.system import SLAMSystem

    __graft_entry__.dryrun_multichip(4)
    print("  dryrun_multichip(4): sharded filter step, ring matcher, reshard, "
          "1-D and 2-D distributed BA equal their single-device references")
    cfg = load_config("configs/panoramic.yaml", {"data.num_steps": 12})
    world = make_panoramic_world(
        num_landmarks=cfg.data.num_landmarks or 300, num_steps=cfg.data.num_steps,
        image_size=cfg.frontend.image_size, seed=cfg.data.seed,
    )
    sys_ = SLAMSystem(cfg)
    est = [sys_.process_frame(world.render(t), world.odom[t]) for t in range(len(world))]
    est = np.asarray(jax.block_until_ready(est))
    sys_.flush_flags()
    print(f"  panoramic on the {dict(sys_.mesh.shape)} mesh: {len(est)} frames, "
          f"{len(sys_.keyframes)} keyframes")
    _check(np.isfinite(est).all(), "panoramic poses not finite")
    res = sys_.run_ba(iters=5)
    _check(res is not None, "panoramic run built no BA problem")
    costs = [float(c) for c in np.asarray(res.costs)]
    print("  distributed BA cost per LM iteration: " + " ".join(f"{c:.6g}" for c in costs))
    _check(all(math.isfinite(c) for c in costs) and costs[-1] <= costs[0],
           "distributed BA cost not finite or not decreasing")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU path and its references")
    ap.add_argument("--frames", type=int, default=60,
                    help="KITTI frames, and EuRoC frames per session")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform!r} devices", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"{need} GPUs needed, {len(devices)} visible", file=sys.stderr)
        return 2

    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    from parakeet_slam_tpu import cli
    from parakeet_slam_tpu.eval.profiling import card_name_and_power_limit
    from parakeet_slam_tpu.utils.compile_cache import enable_compile_cache

    print(card_name_and_power_limit())
    print(f"devices: {len(devices)} x {devices[0].device_kind}; "
          f"compile cache: {enable_compile_cache()}")
    clock = CompileClock()
    if args.four_cards:
        phases = [("four-cards", lambda: phase_four_cards(cli))]
    else:
        phases = [
            ("a corridor", lambda: phase_corridor(cli)),
            ("b kitti_00", lambda: phase_kitti(cli, args.frames)),
            ("c euroc BA", lambda: phase_ba(cli, args.frames)),
            ("d parity", phase_parity),
        ]
    failed = []
    for name, fn in phases:
        print(f"phase {name}", flush=True)
        c0, t0 = clock.total, time.perf_counter()
        try:
            fn()
        except Exception:  # a failed phase is reported; the others still run
            traceback.print_exc()
            failed.append(name)
        wall = time.perf_counter() - t0
        compile_s = clock.total - c0
        print(f"  {name}: {'FAILED' if name in failed else 'ok'}; "
              f"compile {compile_s:.1f} s, rest {wall - compile_s:.1f} s", flush=True)
    if failed:
        print(f"FAILED phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
