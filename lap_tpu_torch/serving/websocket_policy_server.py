"""Websocket policy server (openpi protocol).

Protocol (openpi.serving.websocket_policy_server parity, consumed by
lihzha/lap ``serve_policy.py:101-107``): on connect the server sends
msgpack-numpy-packed metadata; each subsequent client message is a packed
observation dict, answered with a packed inference result. Errors are
reported as a packed traceback string and close the connection.

Copied from ``lap_tpu/serving/websocket_policy_server.py``; ``websockets`` is
imported when the server starts, so importing the port never needs it.
"""

from __future__ import annotations

import asyncio
import logging
import traceback

from lap_tpu_torch.serving import msgpack_numpy

logger = logging.getLogger(__name__)


class WebsocketPolicyServer:
    def __init__(self, policy, host: str = "0.0.0.0", port: int = 8000, *, metadata: dict | None = None):
        self._policy = policy
        self._host = host
        self._port = port
        self._metadata = metadata if metadata is not None else getattr(policy, "metadata", {})

    def serve_forever(self) -> None:
        asyncio.run(self.run())

    async def run(self):
        import websockets.asyncio.server as ws_server

        async with ws_server.serve(
            self._handler,
            self._host,
            self._port,
            compression=None,
            max_size=None,
        ) as server:
            await server.serve_forever()

    async def _handler(self, websocket):
        logger.info("connection from %s", websocket.remote_address)
        await websocket.send(msgpack_numpy.packb(self._metadata))
        while True:
            try:
                payload = await websocket.recv()
            except Exception:
                logger.info("connection closed")
                return
            try:
                obs = msgpack_numpy.unpackb(payload)
                result = await asyncio.get_event_loop().run_in_executor(
                    None, self._policy.infer, obs
                )
                await websocket.send(msgpack_numpy.packb(result))
            except Exception:
                await websocket.send(traceback.format_exc())
                await websocket.close(code=1011, reason="infer error")
                raise
