"""Per-path device times of the flagship workloads, with roofline shares.

Times each plain-XLA path of the ARES EA workloads at the bench shapes: the
screen read (scatter histogram), the flagship track with and without the
read, the ParameterBeam settings sweep (sparse-table path), the
particle-fidelity moment sweep (``ops/sweep.py``) at small and large B, and
the dense particle push.  For each it reports the host-clock time per call
(ending in ``block_until_ready``), the device-busy time per call from a
profiler trace, the top device ops, and — on a device listed in ``PEAKS`` —
the roofline share of the algorithm's FLOPs and bytes.  In the same run it
times a large bf16 matmul and a large copy, which bound what the card
reaches in practice.

Run: python benchmarks/breakdown.py [--out chiprun_out/breakdown.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

# Make the repo root importable no matter where this script is launched from.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

#: Published dense peaks by ``device_kind`` (NVIDIA H100 SXM data sheet, at
#: the full 700 W power limit).  A device missing here gets no roofline.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def roofline(seconds, flops, bytes_, flops_key, peaks):
    """Roofline share against the published peak, or None off-table."""
    if peaks is None:
        return None
    t_flops = flops / peaks[flops_key]
    t_bytes = bytes_ / peaks["hbm_bytes_per_s"]
    return {
        "share": max(t_flops, t_bytes) / seconds,
        "bound": flops_key if t_flops >= t_bytes else "hbm_bytes_per_s",
        "achieved_flops": flops / seconds,
        "achieved_bytes_per_s": bytes_ / seconds,
    }


def measure(name, fn, args, flops, bytes_, flops_key, peaks, results):
    from lynx_tpu.profiling import (
        compile_and_time,
        device_busy_seconds,
        device_op_profile,
    )

    compile_s, wall_s, _ = compile_and_time(fn, *args, repeats=20)
    busy_s = device_busy_seconds(fn, *args, iters=10)
    ops = device_op_profile(fn, *args, iters=10, top=8)
    row = {
        "name": name,
        "compile_s": compile_s,
        "wall_s": wall_s,
        "device_busy_s": busy_s,
        "roofline": roofline(busy_s or wall_s, flops, bytes_, flops_key, peaks),
        "top_ops": [
            {k: op[k] for k in ("name", "us_per_iter", "count_per_iter")}
            for op in ops
        ],
    }
    results.append(row)
    share = row["roofline"]["share"] if row["roofline"] else None
    print(
        f"{name:42s} wall {wall_s * 1e3:9.4f} ms  device {busy_s * 1e3:9.4f}"
        f" ms  compile {compile_s:6.2f} s  roofline"
        f" {'n/a' if share is None else f'{100 * share:.2f}%'}",
        flush=True,
    )


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write the JSON here")
    args = parser.parse_args()

    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import lynx_tpu as lt
    from __graft_entry__ import _flagship
    from lynx_tpu.envs import make_env
    from lynx_tpu.envs.ares_ea import default_params
    from lynx_tpu.functional import track
    from lynx_tpu.ops.histogram import weighted_histogram_2d
    from lynx_tpu.profiling import card

    device = jax.devices()[0]
    peaks = PEAKS.get(device.device_kind)
    results: list = []
    print(f"device {device.platform} {device.device_kind!r} | {card()}")

    # -- calibration: what the card reaches on a plain matmul and a copy.
    a = jnp.ones((8192, 8192), jnp.bfloat16)
    measure("bf16 matmul 8192^3", lambda a: a @ a, (a,), 2 * 8192**3,
            3 * 8192**2 * 2, "bf16_flops", peaks, results)
    big = jnp.ones((256, 1024, 1024), jnp.float32)
    measure("copy 1 GiB f32", lambda x: x * 2.0, (big,), 256 * 2**20,
            2 * 4 * 256 * 2**20, "f32_flops", peaks, results)
    del a, big

    # -- flagship: track + screen read, and its parts.
    n = 100_000
    segment, beam = _flagship(n)
    measure("flagship track+read serial",
            lambda s, b: track(s, b)[1]["AREABSCR1"], (segment, beam),
            2 * 49 * n, 20 * 2040 * 2448 + 2 * 4 * 7 * n,
            "f32_flops", peaks, results)
    seg8, beam8 = _flagship(n, batch_shape=(8,))
    measure("flagship track+read batched B=8",
            lambda s, b: track(s, b)[1]["AREABSCR1"], (seg8, beam8),
            8 * 2 * 49 * n, 8 * (4 * 2040 * 2448 + 2 * 4 * 7 * n),
            "f32_flops", peaks, results)
    xs, ys = beam.xs, beam.ys
    screen = segment.AREABSCR1
    half_w = screen.resolution[0] * screen.pixel_size[0] / 2
    half_h = screen.resolution[1] * screen.pixel_size[1] / 2
    measure("screen read: scatter histogram 1e5 -> 2040x2448",
            lambda x, y: weighted_histogram_2d(
                -y, x, jnp.ones_like(x), (-half_h, half_h), (-half_w, half_w),
                (2040, 2448)),
            (xs, ys), 10 * n, 4 * 2040 * 2448 + 3 * 4 * n,
            "f32_flops", peaks, results)
    opened = lt.Segment([
        el.replace(is_active=False) if el.name == "AREABSCR1" else el
        for el in segment.elements
    ])
    measure("dense push 1e5 (flagship, no read)",
            lambda s, b: track(s, b)[0].particles, (opened, beam),
            2 * 49 * n, 2 * 4 * 7 * n, "f32_flops", peaks, results)

    # -- ParameterBeam settings sweep (sparse-table path), B=1e5.
    env = make_env()
    batch = 100_000
    params = jax.vmap(default_params)(
        jax.random.split(jax.random.PRNGKey(1), batch))
    magnets = jax.random.uniform(
        jax.random.PRNGKey(2), (batch, env.num_actions), minval=-1, maxval=1)
    elements = len(env._segment.flattened().elements)
    # Per setting: build + compose the maps (~100 FLOPs per element, a
    # generous count), then mu' = R mu and Sigma' = R Sigma R^T.
    measure("parameter sweep B=1e5 (table path)",
            env.batched_beam_parameters, (magnets, params),
            batch * (100 * elements + 2 * 49 + 4 * 343),
            batch * 4 * (5 + 4 + 4 + 4), "f32_flops", peaks, results)

    # -- particle-fidelity moment sweep (env method="kernel"), N=1e5.
    pbeam = lt.ParticleBeam.from_parameters(
        num_particles=n, sigma_x=jnp.array([1.75e-4]),
        sigma_y=jnp.array([1.75e-4]), energy=jnp.array([1.073e8]),
        key=jax.random.PRNGKey(3))
    for b in (8, 256):
        m = jax.random.uniform(jax.random.PRNGKey(4), (b, env.num_actions),
                               minval=-0.5, maxval=0.5)
        # Per setting and particle: one composed 7x7 map (2*49) and the
        # weighted first and second moments (2*7 + 2*49); the cloud is read
        # once.
        measure(f"moment sweep B={b} N=1e5 (env kernel route)",
                lambda m, p: env.batched_particle_beam_parameters(
                    m, p, method="kernel"),
                (m, pbeam), b * n * (2 * 49 + 2 * 7 + 2 * 49),
                4 * 7 * n, "f32_flops", peaks, results)

    # -- dense per-setting particle push (B settings x N particles).
    for b, n_b in ((100, 10_000), (32, 100_000)):
        seg_b = env._batched_tuned_segment(
            jax.random.uniform(jax.random.PRNGKey(5), (b, env.num_actions),
                               minval=-0.5, maxval=0.5))
        beam_b = pbeam if n_b == n else lt.ParticleBeam.from_parameters(
            num_particles=n_b, sigma_x=jnp.array([1.75e-4]),
            sigma_y=jnp.array([1.75e-4]), energy=jnp.array([1.073e8]),
            key=jax.random.PRNGKey(6))
        measure(f"dense push B={b} N={n_b}",
                lambda s, p: track(s, p)[0].particles, (seg_b, beam_b),
                2 * 49 * b * n_b, 4 * 7 * n_b + 4 * 7 * b * n_b,
                "f32_flops", peaks, results)

    from lynx_tpu.profiling import _device_trace

    _, names = _device_trace(lambda x: x * 2.0, (jnp.ones(1024),), 2)
    print(f"trace device processes: {names}")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "device_kind": device.device_kind,
            "platform": device.platform,
            "card": card(),
            "peaks": peaks,
            "trace_device_processes": names,
            "rows": results,
        }, indent=1))


if __name__ == "__main__":
    main()
