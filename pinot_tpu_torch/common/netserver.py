"""The in-process TCP servers' socket: bound, listening, and on a port no
old connection holds.

``listen(server_cls, address, handler)`` builds a ``socketserver`` server
(``ThreadingHTTPServer``, ``ThreadingTCPServer``) with a listen backlog
of ``LISTEN_BACKLOG``, and sets ``SO_REUSEADDR`` only where a fixed port
is asked for. Asked for port 0, the kernel then hands out a port with no
connection in TIME_WAIT: with ``SO_REUSEADDR`` it may give the port of a
server just stopped, a client's next SYN to it can come from the source
port an old, server-closed connection used, land on that connection's
TIME_WAIT and go unanswered, and the connect times out. At the standard
library's backlog of 5, a sixth concurrent client's SYN is dropped and
retried a second later.
"""

from __future__ import annotations

from typing import Any, Tuple

LISTEN_BACKLOG = 128


def listen(server_cls, address: Tuple[str, int], handler) -> Any:
    """A ``server_cls`` on ``address``, bound and listening."""
    srv = server_cls(address, handler, bind_and_activate=False)
    srv.allow_reuse_address = address[1] != 0
    srv.request_queue_size = LISTEN_BACKLOG
    try:
        srv.server_bind()
        srv.server_activate()
    except BaseException:
        srv.server_close()
        raise
    return srv
