"""The plugin loader: third-party SPI implementations found at run time.

Counterpart of ``pinot_tpu/spi/plugin.py`` (the reference's
``PluginManager.java:40``): each plugin is a ``.py`` file or a package
directory under ``plugins.dir`` or ``PINOT_PLUGINS_DIR``, and importing
it registers it (it calls the port's registries:
``ingestion.stream.register_stream_type``, ``spi.filesystem.register_fs``,
``spi.crypt.register_crypter``, ...). Names starting with ``_`` are
skipped, and a plugin that fails to import is logged and skipped. A
plugin loads as the module ``pinot_tpu_torch_plugin_<name>`` (JAX's are
``pinot_plugin_<name>``), so a process holding both packages loads a
directory once for each.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import sys

from typing import List, Optional

log = logging.getLogger(__name__)

PLUGINS_DIR_ENV = "PINOT_PLUGINS_DIR"
MODULE_PREFIX = "pinot_tpu_torch_plugin_"


class PluginManager:
    """Ref: PluginManager.java:40 (init/load/get)."""

    def __init__(self, plugins_dir: Optional[str] = None):
        self.plugins_dir = plugins_dir or os.environ.get(PLUGINS_DIR_ENV)
        self.loaded: List[str] = []

    def load_all(self) -> List[str]:
        """Import every plugin module under the plugins dir; returns the
        loaded plugin names (skips, with a log, plugins that fail —
        matching the reference's tolerant startup scan)."""
        d = self.plugins_dir
        if not d or not os.path.isdir(d):
            return []
        for entry in sorted(os.listdir(d)):
            path = os.path.join(d, entry)
            name = None
            if entry.endswith(".py") and not entry.startswith("_"):
                name = entry[:-3]
            elif (os.path.isdir(path)
                  and os.path.isfile(os.path.join(path, "__init__.py"))):
                name = entry
                path = os.path.join(path, "__init__.py")
            if name is None:
                continue
            mod_name = f"{MODULE_PREFIX}{name}"
            if mod_name in sys.modules:
                continue  # idempotent: registrations must not re-run
            try:
                self._load_module(mod_name, path)
                self.loaded.append(name)
            except Exception:  # noqa: BLE001 — one bad plugin isn't fatal
                log.exception("failed to load plugin %s", entry)
        return list(self.loaded)

    @staticmethod
    def _load_module(mod_name: str, path: str):
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or spec.loader is None:
            raise ImportError(f"no module loader for {path!r}")
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            # a half-initialized plugin must not stay importable (python's
            # own import machinery removes failed modules the same way)
            sys.modules.pop(mod_name, None)
            raise
        return module
