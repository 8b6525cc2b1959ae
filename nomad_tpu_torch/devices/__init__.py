"""Device plugins.

Port of ``nomad_tpu/devices/__init__.py``. Reference: plugins/device/
(the DevicePlugin gRPC API) and devices/gpu/nvidia/ (the canonical
out-of-process device plugin, device.go:1), served out-of-process over
the same plugin fabric the task drivers use (plugin.py); the client's
DeviceManager proxies it transparently. The port's NVIDIA device plugin
(the counterpart of ``nomad_tpu``'s ``TPUDevice``) comes with ROADMAP A9.
"""

from .plugin import ExternalDevicePlugin, serve_device_plugin

__all__ = ["ExternalDevicePlugin", "serve_device_plugin"]
