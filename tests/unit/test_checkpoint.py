"""Checkpoint/resume of the DE solver."""
import jax.numpy as jnp
import numpy as np

from camera_linearity.models import calibration as cal
from camera_linearity.utils.checkpoint import DECheckpoint, load_pytree, \
    save_pytree


def test_pytree_roundtrip(tmp_path, rng):
    tree = {"a": rng.normal(size=(4, 5)), "b": np.int32(7)}
    save_pytree(tmp_path / "ckpt", tree)
    back = load_pytree(tmp_path / "ckpt")
    np.testing.assert_allclose(back["a"], tree["a"])
    assert int(back["b"]) == 7


def _solve(checkpoint_path=None, checkpoint_every=0, maxiter=60):
    energy = lambda p: jnp.sum((p - 0.4) ** 2)  # noqa: E731
    return cal.differential_evolution_batched(
        lambda p: energy(p), (), 1, 3,
        np.full(3, -1.0), np.full(3, 1.0), popsize=8, maxiter=maxiter,
        tol=1e-8, mutation=(0.3, 1.0), recombination=0.7, seed=11,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every)


def test_checkpointed_solve_matches_plain(tmp_path):
    plain, _ = _solve()
    ckpt_dir = tmp_path / "de"
    chk, _ = _solve(checkpoint_path=ckpt_dir, checkpoint_every=20)
    # Same generations, same RNG stream -> identical trajectories.
    np.testing.assert_allclose(np.asarray(chk.x), np.asarray(plain.x),
                               rtol=1e-12)
    assert chk.n_iter == plain.n_iter
    assert DECheckpoint.exists(ckpt_dir)


def test_resume_from_checkpoint(tmp_path):
    ckpt_dir = tmp_path / "de"
    # phase 1: stop after 20 generations (checkpointing every 10)
    partial, _ = _solve(checkpoint_path=ckpt_dir, checkpoint_every=10,
                        maxiter=20)
    assert partial.n_iter == 20
    # phase 2: resume to 60; must continue, not restart
    resumed, _ = _solve(checkpoint_path=ckpt_dir, checkpoint_every=10,
                        maxiter=60)
    assert resumed.n_iter >= 20
    assert float(resumed.energy[0]) <= float(partial.energy[0]) + 1e-12
    # matches the uninterrupted run generation-for-generation
    plain, _ = _solve(maxiter=60)
    np.testing.assert_allclose(np.asarray(resumed.energy),
                               np.asarray(plain.energy), rtol=1e-10)


def test_corrupted_checkpoint_degrades_to_fresh_start(tmp_path):
    """A partial/corrupted checkpoint directory (e.g. the process died
    mid-save) must not crash the resume: the solver logs and starts
    fresh, producing the same result as an uncheckpointed run."""
    ckpt_dir = tmp_path / "de"
    _solve(checkpoint_path=ckpt_dir, checkpoint_every=20, maxiter=40)
    assert DECheckpoint.exists(ckpt_dir)
    # corrupt: remove every regular file inside the checkpoint tree
    for p in sorted(ckpt_dir.rglob("*"), reverse=True):
        if p.is_file():
            p.unlink()
    assert DECheckpoint.try_load(ckpt_dir) is None
    recovered, _ = _solve(checkpoint_path=ckpt_dir, checkpoint_every=0,
                          maxiter=60)
    plain, _ = _solve(maxiter=60)
    np.testing.assert_allclose(np.asarray(recovered.x),
                               np.asarray(plain.x), rtol=1e-12)
