"""Smoke test of the main path on one NVIDIA GPU (or four with --four-gpus).

Runs the flagship ARES EA workloads at full size through the entry points a
user calls (``functional.track``, the env, ``lynx_tpu.tune``) and compares
each with a float64 reference computed on the CPU by a child process
(``JAX_PLATFORMS=cpu``, x64 on) that never opens the card.  Each phase
prints one line with its compile seconds, steady-state seconds and its error
in units of its tolerance (``err <= 1`` passes).  The last line of stdout is
one JSON object naming the device; it is printed only when every phase
passed.

    python chip_smoke.py               # phases 1-7 on one card
    python chip_smoke.py --four-gpus   # the sharded paths on four cards
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

N_PARTICLES = 100_000
FLAGSHIP_BATCH = 8
SWEEP_BATCH = 100_000
MOMENT_ENV_BATCH = 512
KERNEL_ENV_BATCH = 256
TUNING_STEPS = 20
#: Target spot size of the tuning phase's loss (m).
TUNING_TARGET = 1e-4
#: Relative tolerance of every f32-vs-f64 comparison.  A TF32 contraction
#: (10 mantissa bits) misses it by about two orders of magnitude.
RTOL = 1e-5
#: Share of particles that may land in a neighbouring screen bin: f32 and
#: f64 bin edges differ in the last bits, so a particle on an edge can fall
#: either side.
MAX_MOVED_SHARE = 1e-4


class PhaseFailure(AssertionError):
    pass


# -- shared model code (GPU process and f64 reference) ----------------------


def _import_repo():
    """Import the package from this checkout, never from elsewhere."""
    if not (REPO / "lynx_tpu" / "__init__.py").is_file():
        sys.exit(f"chip_smoke: no lynx_tpu package beside {__file__}")
    sys.path.insert(0, str(REPO))
    import lynx_tpu

    if Path(lynx_tpu.__file__).resolve().parent.parent != REPO:
        sys.exit(f"chip_smoke: imported lynx_tpu from {lynx_tpu.__file__}")


def _open_screen(segment):
    """The segment with its screen inactive: tracking returns the beam at
    the screen plane instead of the image."""
    import lynx_tpu as lt

    return lt.Segment(
        [
            el.replace(is_active=False) if el.name == "AREABSCR1" else el
            for el in segment.elements
        ],
        name=segment.name,
    )


def _tuning_loss(k1, segment, beam):
    """Relative spot-size error at the screen for quadrupole strengths
    ``k1`` (3,) of AREAMQZM1-3."""
    import lynx_tpu as lt
    from lynx_tpu.functional import track

    names = ("AREAMQZM1", "AREAMQZM2", "AREAMQZM3")
    elements = [
        el.replace(k1=k1[names.index(el.name)][None]) if el.name in names
        else el
        for el in segment.elements
    ]
    out, _ = track(lt.Segment(elements), beam)
    return ((out.sigma_x[0] - TUNING_TARGET) / TUNING_TARGET) ** 2 + (
        (out.sigma_y[0] - TUNING_TARGET) / TUNING_TARGET
    ) ** 2


def _env_params(batch, key):
    import jax

    from lynx_tpu.envs.ares_ea import default_params

    return jax.vmap(default_params)(jax.random.split(key, batch))


# -- the f64 reference (child process, CPU only) ----------------------------


def _reference(inputs: dict) -> dict:
    """f64 CPU results for the phases' inputs (keys ``<phase>.<name>``)."""
    import jax
    import jax.numpy as jnp

    import lynx_tpu as lt
    from __graft_entry__ import _flagship_segment
    from lynx_tpu.envs import make_env
    from lynx_tpu.envs.ares_ea import EnvParams
    from lynx_tpu.functional import track

    assert jax.default_backend() == "cpu" and jax.config.jax_enable_x64

    def f64(tree):
        return jax.tree.map(
            lambda x: jnp.asarray(x, jnp.float64)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
            else x,
            tree,
        )

    def particle_beam(prefix):
        return lt.ParticleBeam(
            f64(inputs[f"{prefix}.particles"]),
            f64(inputs[f"{prefix}.energy"]),
            particle_charges=f64(inputs[f"{prefix}.charges"]),
        )

    out = {}
    for phase in ("serial", "batched"):
        if f"{phase}.particles" in inputs:
            batch_shape = inputs[f"{phase}.energy"].shape
            batch_shape = () if phase == "serial" else batch_shape
            segment = f64(_open_screen(_flagship_segment(batch_shape)))
            outgoing, _ = track(segment, particle_beam(phase))
            out[f"{phase}.particles"] = np.asarray(outgoing.particles)

    env = make_env()
    env._segment = f64(env._segment)
    if "sweep.magnets" in inputs:
        params = EnvParams(
            *(f64(inputs[f"sweep.{f}"]) for f in EnvParams._fields)
        )
        out["sweep.obs"] = np.asarray(
            env.batched_beam_parameters(f64(inputs["sweep.magnets"]), params)
        )
    for phase in ("env_moments", "env_kernel"):
        if f"{phase}.magnets" in inputs:
            out[f"{phase}.obs"] = np.asarray(
                env.batched_particle_beam_parameters(
                    f64(inputs[f"{phase}.magnets"]),
                    particle_beam("env_beam"),
                    method="moments",
                )
            )
    if "tuning.k1" in inputs:
        segment = f64(_open_screen(_flagship_segment()))
        out["tuning.grad"] = np.asarray(
            jax.grad(_tuning_loss)(
                f64(inputs["tuning.k1"]), segment, particle_beam("tuning")
            )
        )
    return out


def _run_reference(inputs: dict) -> dict:
    buffer = io.BytesIO()
    np.savez(buffer, **inputs)
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        JAX_ENABLE_X64="1",
        CUDA_VISIBLE_DEVICES="",
    )
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--reference"],
        input=buffer.getvalue(),
        capture_output=True,
        env=env,
        timeout=900,
    )
    if proc.returncode != 0:
        raise PhaseFailure(
            "f64 reference failed: " + proc.stderr.decode()[-3000:]
        )
    with np.load(io.BytesIO(proc.stdout)) as data:
        return dict(data)


# -- measurement helpers ----------------------------------------------------


def _err(actual, expected, rtol, atol) -> float:
    """Largest ``|actual - expected| / (atol + rtol * |expected|)``."""
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    if actual.shape != expected.shape:
        raise PhaseFailure(f"shape {actual.shape} != {expected.shape}")
    if not np.all(np.isfinite(actual)):
        raise PhaseFailure("non-finite values")
    bound = atol + rtol * np.abs(expected)
    return float(np.max(np.abs(actual - expected) / bound))


def _moved_share(image, reference) -> float:
    """Share of particles that sit in another bin than in ``reference``;
    fails if any moved further than to a neighbouring bin."""
    diff = np.asarray(image, np.float64) - reference
    moved = 0.5 * np.abs(diff).sum()
    if moved > MAX_MOVED_SHARE * reference.sum():
        return moved / max(reference.sum(), 1.0)
    for r, c in zip(*np.nonzero(diff > 0)):
        window = diff[max(r - 1, 0) : r + 2, max(c - 1, 0) : c + 2]
        if not np.any(window < 0):
            raise PhaseFailure(f"bin ({r}, {c}) gained a non-neighbour")
    return moved / max(reference.sum(), 1.0)


def _camera_histogram(particles, screen):
    """``numpy.histogram2d`` (f64) of one particle set, oriented like
    ``screen_reading_particle``: rows are -y, columns x."""
    res = screen.resolution
    pixel = np.asarray(screen.pixel_size, np.float64).reshape(-1, 2)[0]
    half_w = res[0] * pixel[0] / 2
    half_h = res[1] * pixel[1] / 2
    hist, _, _ = np.histogram2d(
        -particles[:, 2],
        particles[:, 0],
        bins=(res[1] // screen.binning, res[0] // screen.binning),
        range=((-half_h, half_h), (-half_w, half_w)),
    )
    return hist


class Phase:
    def __init__(self, name, compile_s, steady_s, check, **note):
        self.name = name
        self.compile_s = compile_s
        self.steady_s = steady_s
        self.check = check
        self.note = note


# -- phases (one card) ------------------------------------------------------


def phase_flagship(batch_shape, inputs):
    """Flagship track + screen read; outgoing coordinates and the image."""
    import jax.numpy as jnp

    from __graft_entry__ import _flagship
    from lynx_tpu.functional import track
    from lynx_tpu.profiling import compile_and_time

    name = "serial" if not batch_shape else "batched"
    segment, beam = _flagship(N_PARTICLES, batch_shape=batch_shape)
    screen = segment.AREABSCR1
    if np.any(np.asarray(screen.misalignment) != 0):
        raise PhaseFailure("flagship screen is misaligned")
    opened = _open_screen(segment)

    def flagship(segment, opened, beam):
        _, diagnostics = track(segment, beam)
        outgoing, _ = track(opened, beam)
        return diagnostics["AREABSCR1"], outgoing.particles, jnp.sum(
            outgoing.survival
            if outgoing.survival is not None
            else jnp.ones_like(outgoing.xs),
            axis=-1,
        )

    compile_s, steady_s, (image, particles, survived) = compile_and_time(
        flagship, segment, opened, beam
    )
    image = np.asarray(image)
    particles = np.asarray(particles)
    survived = np.asarray(survived)
    inputs[f"{name}.particles"] = np.asarray(beam.particles)
    inputs[f"{name}.energy"] = np.asarray(beam.energy)
    inputs[f"{name}.charges"] = np.asarray(beam.particle_charges)

    rows = int(np.prod(batch_shape)) if batch_shape else 1
    expected_shape = (*(batch_shape or (1,)), 2040, 2448)

    def check(ref):
        if image.shape != expected_shape:
            raise PhaseFailure(f"image shape {image.shape}")
        expected = ref[f"{name}.particles"].reshape(rows, -1, 7)
        gpu = particles.reshape(rows, -1, 7)
        images = image.reshape(rows, *image.shape[-2:])
        coord_err, moved = 0.0, 0.0
        for row in range(rows):
            sigma = expected[row].std(axis=0)
            coord_err = max(
                coord_err, _err(gpu[row], expected[row], RTOL, 1e-6 * sigma)
            )
            mass = float(images[row].astype(np.float64).sum())
            if mass != float(survived.reshape(rows)[row]):
                raise PhaseFailure(
                    f"row {row}: image mass {mass} != survivors"
                    f" {survived.reshape(rows)[row]}"
                )
            moved = max(
                moved,
                _moved_share(
                    images[row],
                    _camera_histogram(gpu[row].astype(np.float64), screen),
                ),
            )
        if moved > MAX_MOVED_SHARE:
            raise PhaseFailure(
                f"{moved:.2e} of particles changed bin (coordinates"
                f" err={coord_err:.3g})"
            )
        return coord_err, f"moved={moved:.1e}"

    return Phase(
        f"flagship_{name}", compile_s, steady_s, check,
        shape="x".join(map(str, image.shape)),
    )


def phase_sweep(inputs):
    """ParameterBeam settings sweep through the env at B=1e5."""
    import jax

    from lynx_tpu.envs import make_env
    from lynx_tpu.profiling import compile_and_time

    env = make_env()
    params = _env_params(SWEEP_BATCH, jax.random.PRNGKey(1))
    magnets = jax.random.uniform(
        jax.random.PRNGKey(2), (SWEEP_BATCH, env.num_actions),
        minval=-1.0, maxval=1.0,
    )
    compile_s, steady_s, obs = compile_and_time(
        env.batched_beam_parameters, magnets, params
    )
    obs = np.asarray(obs)
    inputs["sweep.magnets"] = np.asarray(magnets)
    for field, value in zip(params._fields, params):
        inputs[f"sweep.{field}"] = np.asarray(value)
    return Phase(
        "sweep", compile_s, steady_s,
        lambda ref: (_obs_err(obs, ref["sweep.obs"]), f"B={SWEEP_BATCH}"),
    )


def _obs_err(obs, expected) -> float:
    """Observation error: ``(B, 4)`` rows of (mu_x, sigma_x, mu_y, sigma_y).
    Centroids cross zero, so their floor is 1e-5 of the median spot size."""
    scale = np.median(np.abs(expected[:, 1::2]))
    return _err(obs, expected, RTOL, 1e-5 * scale)


def phase_particle_env(method, batch, inputs):
    import jax
    import jax.numpy as jnp

    import lynx_tpu as lt
    from lynx_tpu.envs import make_env
    from lynx_tpu.profiling import compile_and_time

    env = make_env()
    beam = lt.ParticleBeam.from_parameters(
        num_particles=N_PARTICLES,
        sigma_x=jnp.array([1.75e-4]),
        sigma_y=jnp.array([1.75e-4]),
        energy=jnp.array([1.073e8]),
        key=jax.random.PRNGKey(3),
    )
    magnets = jax.random.uniform(
        jax.random.PRNGKey(4), (batch, env.num_actions), minval=-0.5, maxval=0.5
    )
    compile_s, steady_s, obs = compile_and_time(
        lambda m, b: env.batched_particle_beam_parameters(m, b, method=method),
        magnets, beam,
    )
    obs = np.asarray(obs)
    name = "env_moments" if method == "auto" else "env_kernel"
    inputs[f"{name}.magnets"] = np.asarray(magnets)
    inputs["env_beam.particles"] = np.asarray(beam.particles)
    inputs["env_beam.energy"] = np.asarray(beam.energy)
    inputs["env_beam.charges"] = np.asarray(beam.particle_charges)
    return Phase(
        name, compile_s, steady_s,
        lambda ref: (_obs_err(obs, ref[f"{name}.obs"]), f"B={batch}"),
    )


def phase_tuning(inputs):
    """K scanned Adam steps through ``lynx_tpu.tune``; first-step gradient
    against the f64 reference."""
    import jax
    import jax.numpy as jnp
    import optax

    import lynx_tpu as lt
    from __graft_entry__ import _flagship
    from lynx_tpu.profiling import compile_and_time

    segment, beam = _flagship(N_PARTICLES)
    segment = _open_screen(segment)
    k1 = jnp.array([4.2, -4.2, 2.1], jnp.float32)
    optimizer = optax.adam(5e-2)

    _, losses = lt.tune(
        _tuning_loss, k1, segment, beam, optimizer=optimizer,
        steps=TUNING_STEPS,
    )
    losses = np.asarray(losses)
    # Timing through the tuner that ``tune`` builds (one compile, reused).
    tuner = lt.make_tuner(optimizer, _tuning_loss)
    compile_s, steady_s, _ = compile_and_time(
        lambda k1, state, segment, beam: tuner(
            k1, state, TUNING_STEPS, segment, beam
        ),
        k1, optimizer.init(k1), segment, beam,
    )
    grad = np.asarray(jax.jit(jax.grad(_tuning_loss))(k1, segment, beam))
    inputs["tuning.k1"] = np.asarray(k1)
    inputs["tuning.particles"] = np.asarray(beam.particles)
    inputs["tuning.energy"] = np.asarray(beam.energy)
    inputs["tuning.charges"] = np.asarray(beam.particle_charges)

    def check(ref):
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise PhaseFailure(f"loss did not fall: {losses[0]} -> {losses[-1]}")
        expected = ref["tuning.grad"]
        err = _err(grad, expected, 1e-4, 1e-4 * np.max(np.abs(expected)))
        return err, f"K={TUNING_STEPS} loss {losses[0]:.4g}->{losses[-1]:.4g}"

    return Phase("tuning", compile_s, steady_s, check)


def run_one_card(card: str) -> None:
    import jax

    inputs: dict = {}
    phases = [
        phase_flagship((), inputs),
        phase_flagship((FLAGSHIP_BATCH,), inputs),
        phase_sweep(inputs),
        phase_particle_env("auto", MOMENT_ENV_BATCH, inputs),
        phase_particle_env("kernel", KERNEL_ENV_BATCH, inputs),
        phase_tuning(inputs),
    ]
    start = time.perf_counter()
    reference = _run_reference(inputs)
    print(f"f64 reference on the CPU: {time.perf_counter() - start:.1f} s")
    failed = []
    for phase in phases:
        try:
            err, detail = phase.check(reference)
            ok = err <= 1.0
        except PhaseFailure as failure:
            err, detail, ok = float("nan"), str(failure), False
        _print_phase(phase, err, detail, ok, card)
        if not ok:
            failed.append(phase.name)
    precision = jax.config.jax_default_matmul_precision
    print(f"phase precision: jax_default_matmul_precision={precision}"
          " (physics contractions pin Precision.HIGHEST)")
    if failed:
        raise SystemExit(f"chip_smoke: failed phases {failed}")


def _print_phase(phase, err, detail, ok, card):
    extra = " ".join(f"{k}={v}" for k, v in phase.note.items())
    print(
        f"phase {phase.name}: {'ok' if ok else 'FAIL'}"
        f" compile_s={phase.compile_s:.2f} steady_s={phase.steady_s:.6f}"
        f" err={err:.3g} {detail} {extra} | {card}".rstrip()
    )


# -- phases (four cards) ----------------------------------------------------


def run_four_cards(card: str) -> None:
    """The sharded paths on four cards, each against card 0 alone."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import lynx_tpu as lt
    from __graft_entry__ import _flagship
    from lynx_tpu.envs import make_env
    from lynx_tpu.functional import track
    from lynx_tpu.parallel import (
        make_mesh,
        make_pipeline_mesh,
        make_tuning_train_step,
        pipeline_track,
        shard_beam,
        shard_segment,
        split_into_stages,
    )
    from lynx_tpu.profiling import compile_and_time

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-gpus needs 4 devices: {jax.devices()}")
    card0 = jax.devices()[0]
    failed = []

    def on_card0(tree):
        return jax.device_put(tree, card0)

    def report(name, compile_s, steady_s, err, placed, detail=""):
        devices = sorted(d.id for d in placed.sharding.device_set)
        ok = err <= 1.0 and len(devices) == 4
        phase = Phase(name, compile_s, steady_s, None)
        _print_phase(phase, err, f"devices={devices} {detail}", ok, card)
        if not ok:
            failed.append(name)

    # 1. ParameterBeam sweep, batch-sharded over four cards.
    env = make_env()
    mesh = make_mesh(4, batch=4)
    params = _env_params(SWEEP_BATCH, jax.random.PRNGKey(1))
    magnets = jax.random.uniform(
        jax.random.PRNGKey(2), (SWEEP_BATCH, env.num_actions),
        minval=-1.0, maxval=1.0,
    )
    single = np.asarray(
        jax.jit(env.batched_beam_parameters)(on_card0(magnets), on_card0(params))
    )
    batch_sharding = NamedSharding(mesh, P("batch"))
    s_magnets, s_params = jax.device_put((magnets, params), batch_sharding)
    compile_s, steady_s, obs = compile_and_time(
        env.batched_beam_parameters, s_magnets, s_params
    )
    report(
        "four_sweep", compile_s, steady_s, _obs_err(np.asarray(obs), single),
        obs, f"B={SWEEP_BATCH}",
    )

    # 2. Flagship screen read, particle-sharded: the image is reduced
    # across the cards.
    segment, beam = _flagship(N_PARTICLES)

    def read(segment, beam):
        return track(segment, beam)[1]["AREABSCR1"]

    single = np.asarray(jax.jit(read)(on_card0(segment), on_card0(beam)))
    mesh = make_mesh(4, batch=1)
    with mesh:
        s_segment, s_beam = shard_segment(segment, mesh), shard_beam(beam, mesh)
        compile_s, steady_s, image = compile_and_time(read, s_segment, s_beam)
    err = 0.0 if np.array_equal(np.asarray(image), single) else float("inf")
    report(
        "four_screen_read", compile_s, steady_s, err, s_beam.particles,
        f"mass={float(np.asarray(image).sum()):.0f}",
    )

    # 3. One tuning train step, 8 settings x 100k particles, 2x2 mesh.
    segment, beam = _flagship(N_PARTICLES, batch_shape=(FLAGSHIP_BATCH,))
    segment = _open_screen(segment)
    target = jnp.full((FLAGSHIP_BATCH,), TUNING_TARGET)

    def loss_fn(seg, beam):
        outgoing, _ = track(seg, beam)
        return jnp.mean(
            ((outgoing.sigma_x - target) / TUNING_TARGET) ** 2
            + ((outgoing.sigma_y - target) / TUNING_TARGET) ** 2
        )

    optimizer = optax.adam(1e-2)
    step = make_tuning_train_step(optimizer, loss_fn)
    seg0 = on_card0(segment)
    _, _, loss0 = step(seg0, optimizer.init(seg0), on_card0(beam))
    mesh = make_mesh(4)
    with mesh:
        s_segment, s_beam = shard_segment(segment, mesh), shard_beam(beam, mesh)
        state = optimizer.init(s_segment)
        compile_s, steady_s, (_, _, loss) = compile_and_time(
            step, s_segment, state, s_beam
        )
    err = _err(loss, loss0, RTOL, 0.0)
    report(
        "four_train_step", compile_s, steady_s, err, s_beam.particles,
        f"mesh={dict(mesh.shape)} loss={float(loss):.6g}",
    )

    # 4. Pipelined tracking over four stages.
    segment, beam = _flagship(N_PARTICLES)
    segment = _open_screen(segment)
    beam = beam.broadcast((FLAGSHIP_BATCH,))
    single = np.asarray(
        jax.jit(lambda s, b: track(s, b)[0].particles)(
            on_card0(segment), on_card0(beam)
        )
    )
    stages = split_into_stages(segment, 4)
    pp_mesh = make_pipeline_mesh(4)
    compile_s, steady_s, out = compile_and_time(
        lambda stages, beam: pipeline_track(stages, beam, pp_mesh, 4).particles,
        stages, beam,
    )
    sigma = single.reshape(-1, 7).std(axis=0)
    report(
        "four_pipeline", compile_s, steady_s,
        _err(out, single, RTOL, 1e-6 * sigma), out, "stages=4",
    )
    if failed:
        raise SystemExit(f"chip_smoke: failed phases {failed}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-gpus", action="store_true",
        help="run only the sharded paths, on four cards",
    )
    parser.add_argument(
        "--reference", action="store_true",
        help="internal: compute the f64 CPU reference (npz on stdin/stdout)",
    )
    args = parser.parse_args()
    _import_repo()

    if args.reference:
        data = np.load(io.BytesIO(sys.stdin.buffer.read()))
        buffer = io.BytesIO()
        np.savez(buffer, **_reference(dict(data)))
        sys.stdout.buffer.write(buffer.getvalue())
        return

    from lynx_tpu.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    import jax

    from lynx_tpu import profiling

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}"
        )
    card = profiling.card()
    print(f"phase device: devices={devices} kind={devices[0].device_kind!r}"
          f" count={len(devices)} compile_cache={cache} | {card}")
    if args.four_gpus:
        run_four_cards(card)
    else:
        run_one_card(card)
    print(f"nvidia-smi: {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))


if __name__ == "__main__":
    main()
