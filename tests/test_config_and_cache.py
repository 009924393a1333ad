"""Profile reading (VIOConfig.from_yaml) and the compile-cache location."""
import os
import pathlib
import subprocess
import sys

import pytest

from ekf_vio_tpu.config import VIOConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
PROFILES = sorted((REPO / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", PROFILES, ids=[p.name for p in PROFILES])
def test_profile_reader_matches_yaml(path):
    """The flat-profile reader gives the same VIOConfig as a YAML parser
    on every shipped profile."""
    yaml = pytest.importorskip("yaml")
    assert VIOConfig.from_yaml(str(path)) == VIOConfig.from_dict(
        yaml.safe_load(path.read_text()) or {})


def test_profile_reader_rejects_bad_values(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("use_imu: maybe\n")
    with pytest.raises(ValueError, match="true/false"):
        VIOConfig.from_yaml(str(p))
    p.write_text("max_features: lots\n")
    with pytest.raises(ValueError, match="as int"):
        VIOConfig.from_yaml(str(p))


_PROBE = """
import jax, jax.numpy as jnp, ekf_vio_tpu
d = ekf_vio_tpu.enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print(d)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()[-2:]


def test_compile_cache_uses_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache goes there and
    nowhere else."""
    got, cfg_dir = _probe(tmp_path)
    assert got == cfg_dir == str(tmp_path)
    assert any(tmp_path.iterdir()), "nothing was cached in the env dir"


def test_compile_cache_default_dir():
    """Without it, the cache goes to the fixed <repo>/.jax_cache."""
    got, cfg_dir = _probe(None)
    assert got == cfg_dir == str(REPO / ".jax_cache")
