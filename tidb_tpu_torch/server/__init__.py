"""MySQL wire protocol server (ref: server/ — conn handling, handshake,
COM_QUERY dispatch, resultset writing)."""

from tidb_tpu_torch.server.server import Server

__all__ = ["Server"]
