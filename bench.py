"""Headline benchmark: ARES EA tracking throughput on one GPU.

Reproduces the reference's speed contract (``tests/test_speed.py:21-28``):
the ARES Experimental Area subcell (AREASOLA1 -> AREABSCR1), a 100,000-
particle beam, an active screen — track + screen read.  The reference's bar
is < 0.1 s per track on a CI CPU (PyTorch Cheetah), i.e. 10 tracks/s;
``vs_baseline`` is measured against that.

Headline value: per-track throughput in the better dispatch mode (serial or
B=8 settings batched per dispatch), chosen from the MEASURED numbers.  The
JSON line also carries the settings-sweep rate (vectorized ParameterBeam
env-steps/s) and the 100k-ParticleBeam env-step rates of the moment route
and of the particle-fidelity moment sweep.

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "serial_tracks_per_s": N, "batched_tracks_per_s": N, "batch_size": 8,
     "sweep_env_steps_per_s": N, "particle_env_steps_per_s": N,
     "particle_env_method": "moment_exact",
     "particle_env_kernel_steps_per_s": N,
     "platform": "gpu", "device_kind": ..., "count": N, "card": ...,
     "paths": {name: "ok"|error}}

Each metric runs in its own subprocess, one after another, so one JAX
process holds the card at a time and a crash records ``null`` for that
metric only.  A metric that finds no GPU fails; there is no CPU fallback.

Run: python bench.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# Make `__graft_entry__` (and the package) importable regardless of the
# caller's working directory.
_REPO_DIR = str(Path(__file__).resolve().parent)
if _REPO_DIR not in sys.path:
    sys.path.insert(0, _REPO_DIR)

BASELINE_TRACKS_PER_S = 10.0  # reference: < 0.1 s / track on CPU

FLAGSHIP_PARTICLES = 100_000
SWEEP_BATCH = 100_000
#: A realistic RL population for the moment route of the particle env.
PARTICLE_ENV_BATCH = 512
#: Settings of the particle-fidelity moment sweep (env ``method="kernel"``).
PARTICLE_KERNEL_BATCH = 256
# Delta-K pair for the loop-carried measurement harness
# (lynx_tpu.profiling.marginal_seconds_per_iter): differencing two chain
# lengths cancels the fixed dispatch + fetch cost of a call, which is
# larger than a microsecond-scale step.
K_SMALL, K_LARGE = 16, 256

#: Wall-clock budget per metric subprocess (compile + timing).
PER_METRIC_TIMEOUT_S = 900.0


def _flagship_throughput(batch: int) -> float:
    """Tracks/s for the flagship (track + full screen read) at ``batch``
    settings per dispatch: device time via the loop-carried delta-K
    harness (every iteration's beam is perturbed by a numerically-invisible
    epsilon derived from the previous screen image, so iterations can be
    neither hoisted nor overlapped)."""
    import jax.numpy as jnp

    import lynx_tpu as lt
    from __graft_entry__ import _flagship
    from lynx_tpu.functional import track
    from lynx_tpu.profiling import marginal_seconds_per_iter

    batch_shape = () if batch == 1 else (batch,)
    segment, beam = _flagship(
        num_particles=FLAGSHIP_PARTICLES, batch_shape=batch_shape
    )

    def step(carry):
        particles, eps = carry
        b = lt.ParticleBeam(
            particles + eps,
            beam.energy,
            particle_charges=beam.particle_charges,
            survival=beam.survival,
        )
        _, diagnostics = track(segment, b)
        image = diagnostics["AREABSCR1"]
        return particles, jnp.sum(image) * jnp.float32(1e-30)

    per_call = marginal_seconds_per_iter(
        step, (beam.particles, jnp.float32(0.0)), K_SMALL, K_LARGE
    )
    return batch / per_call


def _sweep_env_steps_per_s(batch: int = None) -> float:
    """Vectorized settings-sweep rate: B ParameterBeam instances through the
    ARES EA per second."""
    import jax
    import jax.numpy as jnp

    from lynx_tpu.envs import make_env
    from lynx_tpu.envs.ares_ea import default_params
    from lynx_tpu.profiling import marginal_seconds_per_iter

    batch = SWEEP_BATCH if batch is None else batch
    env = make_env()
    params = jax.vmap(default_params)(
        jax.random.split(jax.random.PRNGKey(1), batch)
    )
    magnets = jnp.zeros((batch, env.num_actions))

    def step(carry):
        m, eps = carry
        out = env.batched_beam_parameters(m + eps, params)
        return m, jnp.sum(out) * jnp.float32(1e-30)

    per_call = marginal_seconds_per_iter(
        step, (magnets, jnp.float32(0.0)), K_SMALL, 4 * K_LARGE
    )
    return batch / per_call


def _particle_env_steps_per_s(batch: int = None, method: str = "auto") -> float:
    """Full-fidelity env-step rate: B settings x one shared 100k-particle
    beam observed through the EA with sample-moment observation per second.

    ``method="auto"`` resolves to the exact moment-sufficiency route for
    the (purely linear) EA — algebraically identical observations to
    pushing all N particles (``tests/test_moment_sufficiency.py``);
    ``method="kernel"`` times the particle-fidelity moment sweep
    (``ops/sweep.py``, the path that generalizes to interleaved
    apertures)."""
    import jax
    import jax.numpy as jnp

    import lynx_tpu as lt
    from lynx_tpu.envs import make_env
    from lynx_tpu.profiling import marginal_seconds_per_iter

    batch = PARTICLE_ENV_BATCH if batch is None else batch
    env = make_env()
    beam = lt.ParticleBeam.from_parameters(
        num_particles=FLAGSHIP_PARTICLES,
        sigma_x=jnp.array([1.75e-4]),
        sigma_y=jnp.array([1.75e-4]),
        energy=jnp.array([1.073e8]),
        key=jax.random.PRNGKey(3),
    )
    magnets = jax.random.uniform(
        jax.random.PRNGKey(4), (batch, env.num_actions), minval=-0.5, maxval=0.5
    )

    def step(carry):
        m, eps = carry
        out = env.batched_particle_beam_parameters(m + eps, beam, method=method)
        return m, jnp.sum(out) * jnp.float32(1e-30)

    # The moment route iterates in microseconds: lengthen the chain until
    # the marginal term dominates the noise of the fixed per-call cost.
    for k_large in (2 * K_LARGE, 2048, 8192):
        per_call = marginal_seconds_per_iter(
            step, (magnets, jnp.float32(0.0)), K_SMALL, k_large
        )
        if per_call * k_large > 2e-3:
            break
    return batch / per_call


#: metric name -> zero-arg measurement returning a float.
METRICS = {
    "serial": lambda: _flagship_throughput(batch=1),
    "batched": lambda: _flagship_throughput(batch=8),
    "sweep": _sweep_env_steps_per_s,
    "particle_env": _particle_env_steps_per_s,
    "particle_env_kernel": lambda: _particle_env_steps_per_s(
        batch=PARTICLE_KERNEL_BATCH, method="kernel"
    ),
}


def _rounded(value, digits):
    return round(value, digits) if value else None


def _assemble(values: dict, paths: dict, device: dict) -> dict:
    """Build the one-line JSON result from per-metric values (None = that
    path failed; see ``paths`` for the error)."""
    serial = values.get("serial")
    batched = values.get("batched")
    # Headline = the better MEASURED dispatch mode.
    candidates = [(v, m) for v, m in ((batched, "batched"), (serial, "serial")) if v]
    headline, mode = max(candidates) if candidates else (None, "none")
    return {
        "metric": "ares_ea_100k_track_and_screen_read_throughput",
        "value": _rounded(headline, 3),
        "unit": "tracks/s",
        "vs_baseline": _rounded(
            headline and headline / BASELINE_TRACKS_PER_S, 3
        ),
        "headline_mode": mode,
        "serial_tracks_per_s": _rounded(serial, 3),
        "batched_tracks_per_s": _rounded(batched, 3),
        "batch_size": 8,
        "sweep_env_steps_per_s": _rounded(values.get("sweep"), 1),
        "particle_env_steps_per_s": _rounded(values.get("particle_env"), 1),
        "particle_env_batch": PARTICLE_ENV_BATCH,
        # The EA is purely linear, so the auto route is the exact
        # moment-sufficiency path (identical observations to pushing all
        # particles; tests/test_moment_sufficiency.py).
        "particle_env_method": "moment_exact",
        "particle_env_kernel_steps_per_s": _rounded(
            values.get("particle_env_kernel"), 1
        ),
        "particle_env_kernel_batch": PARTICLE_KERNEL_BATCH,
        **device,
        "paths": paths,
    }


def _measure_metric_in_subprocess(name: str) -> tuple[dict | None, str]:
    """Run ONE metric in a killable subprocess; returns (its JSON record —
    ``{"value", "platform", "device_kind", "count"}`` — or None, status)."""
    try:
        proc = subprocess.run(
            [
                sys.executable,
                str(Path(__file__).resolve()),
                "--measure-only",
                name,
            ],
            timeout=PER_METRIC_TIMEOUT_S,
            capture_output=True,
            text=True,
        )
    except subprocess.TimeoutExpired:
        return None, "timeout"
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()
        return None, f"rc={proc.returncode}: {' | '.join(tail[-3:])[-400:]}"
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            record = json.loads(line)
            record["value"] = float(record["value"])
            return record, "ok"
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            continue
    return None, "no JSON output"


def _measure_only(name: str) -> dict:
    """Measure one metric in this process, on the GPU only."""
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"bench: needs a GPU, JAX found {device.platform!r}"
        )
    return {
        "value": METRICS[name](),
        "platform": device.platform,
        "device_kind": device.device_kind,
        "count": len(jax.devices()),
    }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--measure-only",
        metavar="METRIC",
        choices=sorted(METRICS),
        help="internal: measure ONE metric on the GPU and print"
        ' {"value": N, ...}',
    )
    args = parser.parse_args()

    if args.measure_only:
        print(json.dumps(_measure_only(args.measure_only)))
        return

    values: dict = {}
    paths: dict = {}
    device: dict = {"platform": None, "device_kind": None, "count": None}
    for name in METRICS:
        record, paths[name] = _measure_metric_in_subprocess(name)
        values[name] = record and record["value"]
        if record:
            device = {k: record[k] for k in device}
        else:
            print(
                f"bench: metric {name!r} failed ({paths[name]});"
                " recording null for it",
                file=sys.stderr,
            )
    from lynx_tpu.profiling import card

    device["card"] = card()
    print(json.dumps(_assemble(values, paths, device)))


if __name__ == "__main__":
    main()
