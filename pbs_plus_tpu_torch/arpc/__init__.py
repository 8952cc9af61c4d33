"""The aRPC call layer of the port: copies of the JAX package's
``arpc/mux.py`` (the stream multiplexer), ``arpc/call.py`` (request and
response envelopes, ``Session.call``) and ``arpc/binary_stream.py``,
which the verification job's agent-side drift check calls through.  The
router, transports and agents manager are not copied: the job reaches a
connected agent through the server's ``agents``, which a caller brings.
"""

from .mux import MuxConnection, MuxStream, MuxError
from .call import (CallError, Request, Response, Session, STATUS_OK,
                   STATUS_ERROR, STATUS_RAW_STREAM)

__all__ = [
    "MuxConnection", "MuxStream", "MuxError",
    "CallError", "Request", "Response", "Session",
    "STATUS_OK", "STATUS_ERROR", "STATUS_RAW_STREAM",
]
