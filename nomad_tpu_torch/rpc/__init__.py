"""RPC fabric (port of ``nomad_tpu/rpc``; reference: nomad/rpc.go,
helper/pool/). Host code: nothing here imports torch."""

from .client import AuthFailedError, ConnPool, RPCError
from .keyring import Keyring
from .server import RPCServer, StreamSession

__all__ = [
    "AuthFailedError",
    "ConnPool",
    "Keyring",
    "RPCError",
    "RPCServer",
    "StreamSession",
]
