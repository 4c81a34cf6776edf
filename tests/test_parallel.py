"""Parallel/distributed machinery tests on the virtual 8-device CPU mesh
(conftest forces the CPU backend with xla_force_host_platform_device_count)."""
import os

import numpy as np
import pytest


def test_mesh_construction():
    import jax
    from avrecode_jax.parallel.mesh import make_mesh
    n = len(jax.devices())
    if n < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(n_gop=4, n_lane=2)
    assert mesh.shape == {"gop": 4, "lane": 2}


def test_sharded_recompress_step_matches_single_device():
    """The GOP x lane sharded step must produce the identical probabilities
    and lane words as the unsharded per-chunk path (multi-chip determinism:
    SURVEY.md §7 hard part 4)."""
    import jax
    import jax.numpy as jnp
    from avrecode_jax.parallel.mesh import make_mesh
    from avrecode_jax.parallel.pipeline import sharded_recompress_step
    from avrecode_jax.ops import model_pass as mp

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(n_gop=4, n_lane=2)
    G, N, batch = 4, 512, 256
    n_dual, n_sig = 64, 128
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (G, N)).astype(np.int32)
    kinds = rng.integers(0, 3, (G, N)).astype(np.int32)
    keys = np.where(kinds == 2, rng.integers(0, n_sig, (G, N)),
                    rng.integers(0, n_dual - 1, (G, N))).astype(np.int32)
    priors = rng.integers(1, 32767, (G, N)).astype(np.int32)
    dual0 = np.ones((G, n_dual, 4), np.int32) * 3
    sig0 = np.zeros((G, n_sig, 2), np.int32)

    build = sharded_recompress_step(mesh, batch=batch)
    step = build(K_total=8)
    probs, x_final, words, emits, total_words = step(
        *map(jnp.asarray, (bits, kinds, keys, priors, dual0, sig0)))

    for g in range(G):
        ref = mp.model_pass(*map(jnp.asarray,
                                 (bits[g], kinds[g], keys[g], priors[g], dual0[g], sig0[g])),
                            batch=batch, fast_w=48, slow_w=640, sig_w=80, sig_alpha=1)
        assert np.array_equal(np.asarray(probs)[g], np.asarray(ref)), f"chunk {g}"
    assert int(total_words) > 0


def test_mesh_real_clip_container(corpus_dir):
    """PRODUCT mesh path on REAL data: a multi-GOP x264 clip compressed
    through device.compress_mesh on the 8-device CPU mesh must emit a
    container byte-identical to the single-device path's, and the host C++
    serial decoder must roundtrip it bit-exactly."""
    import jax
    from avrecode_jax import device, pipeline
    from avrecode_jax.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    with open(os.path.join(corpus_dir, "ipb_high.mp4"), "rb") as f:
        data = f.read()
    mesh = make_mesh(n_gop=4, n_lane=2)
    comp_mesh, st = device.compress_mesh(data, mesh, chunk_mode=1,
                                         batch_size=512, sup=4, force_lanes=4)
    comp_single, _ = device.compress(data, chunk_mode=1, batch_size=512,
                                     force_lanes=4)
    assert st.n_chunks > 1
    assert comp_mesh == comp_single
    dec, _ = pipeline.decompress(comp_mesh)
    assert dec == data


def test_corpus_compress_single_process(corpus_dir, tmp_path):
    """File-level corpus orchestration: shard, compress, verify, report."""
    from avrecode_jax.parallel import distributed as dist
    paths = [os.path.join(corpus_dir, n)
             for n in ["i_main.264", "cavlc.mp4", "mbaff.264"]]
    rep = dist.corpus_compress(paths, str(tmp_path), use_device=False, verify=True)
    assert rep.failures == 0
    assert rep.files == 3
    assert rep.ratio < 1.0
    assert len(os.listdir(tmp_path)) == 3


def test_corpus_resume(corpus_dir, tmp_path):
    """Checkpoint/resume: a second run skips completed outputs (existence is
    trustworthy — outputs are written atomically) but redoes missing ones."""
    import time
    from avrecode_jax.parallel import distributed as dist
    paths = [os.path.join(corpus_dir, n) for n in ["i_main.264", "cavlc.mp4"]]
    rep1 = dist.corpus_compress(paths, str(tmp_path), verify=True)
    assert rep1.failures == 0 and rep1.files == 2
    # Delete one output; the resumed run must redo only that file.
    victim = os.path.join(str(tmp_path), "cavlc.mp4.atrc")
    kept = os.path.join(str(tmp_path), "i_main.264.atrc")
    os.remove(victim)
    kept_mtime = os.path.getmtime(kept)
    time.sleep(0.01)
    rep2 = dist.corpus_compress(paths, str(tmp_path), verify=True, resume=True)
    assert rep2.failures == 0 and rep2.files == 2
    assert os.path.exists(victim)
    assert os.path.getmtime(kept) == kept_mtime  # untouched
    assert rep2.ratio == pytest.approx(rep1.ratio)


def test_corpus_cli(corpus_dir, tmp_path):
    from avrecode_jax import cli
    rc = cli.main(["corpus", os.path.join(corpus_dir, "*.264"), str(tmp_path)])
    assert rc == 0
    assert len(os.listdir(tmp_path)) > 0


def test_corpus_two_processes(corpus_dir, tmp_path):
    """Real multi-process orchestration (BASELINE config 5 shape): two jax
    processes share one coordinator, shard the corpus, and psum-merge stats
    over the cross-process collective."""
    import json
    import socket
    import subprocess
    import sys
    import textwrap

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    script = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        import jax
        jax.config.update("jax_platforms", "cpu")
        os.environ["JAX_COORDINATOR"] = "localhost:{port}"
        os.environ["JAX_NUM_PROCESSES"] = "2"
        os.environ["JAX_PROCESS_ID"] = sys.argv[1]
        from avrecode_jax import cli
        sys.exit(cli.main(["corpus", {repr(os.path.join(corpus_dir, '*.264'))},
                           {repr(str(out_dir))}]))
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))
             for i in range(2)]
    reports = []
    for pr in procs:
        out, err = pr.communicate(timeout=240)
        assert pr.returncode == 0, err[-2000:]
        reports.append(json.loads(out.strip().splitlines()[-1]))
    # Both processes see the merged (global) stats and no failures.
    assert reports[0]["files"] == reports[1]["files"] > 0
    assert reports[0]["failures"] == 0 and reports[1]["failures"] == 0
    n_264 = len([n for n in os.listdir(corpus_dir) if n.endswith(".264")])
    assert reports[0]["files"] == n_264
    assert len(os.listdir(out_dir)) == n_264
