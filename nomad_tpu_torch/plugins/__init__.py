"""Plugin interfaces beyond task drivers.

Port of ``nomad_tpu/plugins/__init__.py``.

Reference: plugins/ — base handshake (plugins/base), driver wrappers
(plugins/drivers, implemented in drivers/plugin.py), device
plugins (plugins/device, implemented in client/devicemanager.py),
and the CSI client (plugins/csi) implemented here in csi.py.
"""

from .csi import (
    CSIError,
    CSIPlugin,
    ExternalCSIPlugin,
    FakeCSIPlugin,
    serve_csi_plugin,
)

__all__ = [
    "CSIError",
    "CSIPlugin",
    "ExternalCSIPlugin",
    "FakeCSIPlugin",
    "serve_csi_plugin",
]
