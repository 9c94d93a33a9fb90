"""Where the package keeps JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself and the
package sets nothing); otherwise the cache sits at a fixed path inside the
checkout, so every run of the same checkout finds it again.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import jax, triangulation_in_deformable_scenes_tpu; "
    "print(jax.config.jax_compilation_cache_dir)"
)


def _cache_dir_seen(env_update, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", **env_update})
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_env_variable_is_honoured(tmp_path):
    target = str(tmp_path / "cache")
    assert _cache_dir_seen({"JAX_COMPILATION_CACHE_DIR": target}) == target


def test_default_is_fixed_path_in_checkout():
    seen = _cache_dir_seen({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert seen == os.path.join(REPO, ".jax_cache")
