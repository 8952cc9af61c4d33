"""The aRPC fabric of the port: copies of the JAX package's ``arpc/mux.py``
(the stream multiplexer), ``arpc/call.py`` (request and response
envelopes, ``Session.call``), ``arpc/binary_stream.py`` (raw-stream
bodies), ``arpc/router.py`` (the method router), ``arpc/transport.py``
(the mTLS TCP transport and its handshake, with the plain loopback mode)
and ``arpc/agents_manager.py`` (the session registry: admission, token
buckets, job-session expectations, crashed-session watches).  The
envelopes are msgpack, imported where a frame is packed, so the package
imports without it.
"""

from .mux import MuxConnection, MuxStream, MuxError
from .call import (CallError, Request, Response, Session, STATUS_OK,
                   STATUS_ERROR, STATUS_RAW_STREAM)
from .router import Router, HandlerError
from .transport import (connect_to_server, serve, TlsServerConfig,
                        TlsClientConfig)
from .agents_manager import (AdmissionDeadlineError, AdmissionRejected,
                             AgentsManager, ClientSession)
from .binary_stream import (send_data_from_reader, receive_data_into,
                            MAX_FRAME, StreamLengthError)

__all__ = [
    "MuxConnection", "MuxStream", "MuxError",
    "CallError", "Request", "Response", "Session",
    "STATUS_OK", "STATUS_ERROR", "STATUS_RAW_STREAM",
    "Router", "HandlerError",
    "connect_to_server", "serve", "TlsServerConfig", "TlsClientConfig",
    "AdmissionDeadlineError", "AdmissionRejected", "AgentsManager",
    "ClientSession",
    "send_data_from_reader", "receive_data_into", "MAX_FRAME",
    "StreamLengthError",
]
