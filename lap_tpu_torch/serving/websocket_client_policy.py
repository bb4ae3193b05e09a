"""Websocket policy client (openpi_client.websocket_client_policy parity),
used by the LIBERO / real-robot runners.

Copied from ``lap_tpu/serving/websocket_client_policy.py``; ``websockets`` is
imported when a client connects, so importing the port never needs it."""

from __future__ import annotations

import logging
import time

from lap_tpu_torch.serving import msgpack_numpy

logger = logging.getLogger(__name__)


class WebsocketClientPolicy:
    def __init__(self, host: str = "localhost", port: int = 8000, *, api_key: str | None = None):
        self._uri = f"ws://{host}:{port}"
        self._packer = msgpack_numpy.Packer()
        self._api_key = api_key
        self._ws, self._server_metadata = self._wait_for_server()

    def get_server_metadata(self) -> dict:
        return self._server_metadata

    def _wait_for_server(self):
        import websockets.sync.client as ws_client

        logger.info("Waiting for server at %s...", self._uri)
        while True:
            try:
                headers = {"Authorization": f"Api-Key {self._api_key}"} if self._api_key else None
                conn = ws_client.connect(
                    self._uri, compression=None, max_size=None, additional_headers=headers
                )
                metadata = msgpack_numpy.unpackb(conn.recv())
                return conn, metadata
            except ConnectionRefusedError:
                logger.info("Still waiting for server...")
                time.sleep(2)

    def infer(self, obs: dict) -> dict:
        data = self._packer.pack(obs)
        self._ws.send(data)
        response = self._ws.recv()
        if isinstance(response, str):
            raise RuntimeError(f"Error in inference server:\n{response}")
        return msgpack_numpy.unpackb(response)

    def reset(self) -> None:
        pass

    def close(self):
        self._ws.close()
