"""L5: REST transport — server routes and the client-side service proxy.

Two wire-identical server planes share one dispatch core (``base.py``):
the thread-per-connection ``SdaHttpServer`` and the asyncio event-loop
``SdaAsyncHttpServer`` (``sdad --async``, docs/scaling.md)."""

from .aserver import SdaAsyncHttpServer
from .client import SdaHttpClient
from .server import SdaHttpServer


def server_class(async_http: bool = False):
    """The plane selector every driver shares (``--async`` flags)."""
    return SdaAsyncHttpServer if async_http else SdaHttpServer
