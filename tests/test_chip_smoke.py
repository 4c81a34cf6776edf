"""CPU-side guarantees of the GPU tooling: chip_smoke.py refuses to run
without a GPU, the compile cache sits where it is documented to, and the
shared bit-exactness checks (avrecode_jax.checks) hold on the CPU backend."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No GPU (or no repo beside the script): non-zero exit, no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, str(script)], cwd=os.path.dirname(str(script)),
                       env=_cpu_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _cache_dir(env: dict) -> str:
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; from avrecode_jax import device; "
         "d = device.ensure_compile_cache(); "
         "assert d == jax.config.jax_compilation_cache_dir; print(d)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_env_var(tmp_path):
    want = str(tmp_path / "jaxcache")
    assert _cache_dir(_cpu_env(JAX_COMPILATION_CACHE_DIR=want)) == want


def test_compile_cache_default_in_checkout():
    assert _cache_dir(_cpu_env()) == os.path.join(REPO, ".jax_cache")


def test_compile_cache_path_is_fixed(tmp_path):
    """The default path depends on neither the temp dir nor the process."""
    dirs = []
    for i in range(2):
        tmp = tmp_path / f"tmp{i}"
        tmp.mkdir()
        dirs.append(_cache_dir(_cpu_env(TMPDIR=str(tmp))))
    assert dirs[0] == dirs[1]
    assert not dirs[0].startswith(str(tmp_path))


def test_checks_on_cpu_backend(corpus_dir):
    """The helpers chip_smoke.py and tests/test_gpu.py share, run on the CPU
    backend: differential, container equality, host roundtrip."""
    import jax
    from avrecode_jax import checks
    with open(os.path.join(corpus_dir, "i_main.264"), "rb") as f:
        data = f.read()
    assert checks.chunk_differential(data, chunk_mode=0, model_profile=2,
                                     batch_size=1024) >= 1
    comp = checks.container_matches(data, jax.devices("cpu")[0], batch_size=1024)
    with pytest.raises(checks.MismatchError):
        checks.check_roundtrip(data[:-1], comp)
