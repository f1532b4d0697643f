"""The port's test-side pin of its result cache: off by default.

Every ``tests/test_torch_*.py`` imports this module first. Execution-path
tests re-run identical statements on one context and read the engine's
per-run stats (mode, route, launches); a semantic-cache hit would answer
without executing and erase them. ``tests/conftest.py`` pins the JAX
package's registry default the same way for the JAX suite; the port's
registry is its own, so it gets its own pin here. The package's real
default stays True, as in the JAX package. The cache tests
(``tests/test_torch_cache.py``) turn the cache back on per context.
"""

import dataclasses

from spark_druid_olap_tpu_torch.utils import config as _config

#: the default the package itself declares (this module is imported once
#: per process, so it reads the registry before the pin)
PACKAGE_DEFAULT = _config.CACHE_ENABLED.default

_config._REGISTRY["sdot.cache.enabled"] = dataclasses.replace(
    _config.CACHE_ENABLED, default=False)
_config.CACHE_ENABLED = _config._REGISTRY["sdot.cache.enabled"]


def test_pin_turns_the_port_cache_off_by_default_only_in_tests():
    import spark_druid_olap_tpu_torch as tsdot
    assert PACKAGE_DEFAULT is True
    ctx = tsdot.Context(device="cpu")
    assert ctx.config.get("sdot.cache.enabled") is False
    assert not ctx.engine.result_cache.enabled
    ctx.config.set("sdot.cache.enabled", True)
    assert ctx.engine.result_cache.enabled
