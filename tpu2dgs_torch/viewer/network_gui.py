"""The remote viewer's TCP bridge (port of tpu2dgs/viewer/network_gui.py),
wire-compatible with the JAX package's server and the reference
(gaussian_renderer/network_gui.py:27-98), so existing viewer binaries
connect unchanged:

  server -> client on connect: u32-LE length + JSON list of render items
  client -> server per frame:  u32-LE length + JSON control message
  server -> client response:   raw H*W*3 u8 image bytes (if a camera was
                               given), then u32-LE length + ascii verify
                               string, then u32-LE length + JSON metrics

The received view matrix gets the reference's axis flips (columns 1, 2 of
the view, column 1 of the view-projection) before use, and the camera is
built on the GUI's device. `NetworkGUI.serve` answers one request with a
frame; `cli.view` and `Trainer(gui=)` both serve through it.

Under a mesh rank 0 alone owns the socket, and the other ranks hold a
`Follower`; rank 0 tells them about each request as one word
(`request_word`, `read_request`).
"""

from __future__ import annotations

import json
import math
import socket
import struct
import traceback
from typing import Optional

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.core.cameras import CameraArrays
from tpu2dgs_torch.viewer.modes import render_net_image

RENDER_ITEMS = ["RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"]

# A request as rank 0 broadcasts it under a mesh: one float64 vector, which
# holds the float32 camera, the client's scaling modifier and small integers
# exactly: [code, width, height, scaling modifier, world_view (16),
# full_proj (16), cam_center (3), tanfovx, tanfovy, znear, zfar].
WORD_LEN = 43


class NetworkGUI:
    """A listening socket and at most one connected viewer client. The
    cameras `receive` returns lie on `device` (default: the GPU)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009, device=None):
        self.host = host
        self.port = port
        self.device = default_device(device)
        self.listener: Optional[socket.socket] = None
        self.conn: Optional[socket.socket] = None
        self.render_items = RENDER_ITEMS  # as sent to the client: its modes index them

    def init(self) -> None:
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((self.host, self.port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self, render_items=None) -> None:
        """Accept a client if one is waiting (no wait) and send it the
        render items."""
        if self.listener is None:
            return
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            self.render_items = render_items or RENDER_ITEMS
            self._send_json(self.render_items)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _send_json(self, data) -> None:
        payload = json.dumps(data).encode("utf-8")
        self.conn.sendall(struct.pack("<I", len(payload)))
        self.conn.sendall(payload)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed")
            buf += chunk
        return buf

    def receive(self):
        """Read one control message. Returns (camera or None, (w, h),
        do_training, keep_alive, scaling_modifier, render_mode); a message
        with a zero resolution, or one that does not parse, gives
        (None, (0, 0), None, None, None, None) and keeps the connection."""
        (length,) = struct.unpack("<I", self._recv_exact(4))
        payload = self._recv_exact(length)
        try:
            msg = json.loads(payload.decode("utf-8"))
            width, height = int(msg["resolution_x"]), int(msg["resolution_y"])
            if width == 0 or height == 0:
                return None, (0, 0), None, None, None, None
            render_mode = int(msg.get("render_mode", 0))
            if width < 0 or height < 0 or not 0 <= render_mode < len(self.render_items):
                raise ValueError(f"resolution {width}x{height}, render mode {render_mode}")
            do_training = bool(msg["train"])
            keep_alive = bool(msg["keep_alive"])
            scaling_modifier = float(msg["scaling_modifier"])
            world_view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
            world_view[:, 1] = -world_view[:, 1]
            world_view[:, 2] = -world_view[:, 2]
            full_proj = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
            full_proj[:, 1] = -full_proj[:, 1]
            # float32 numpy, as the JAX server computes it: the same bits
            cam_center = np.linalg.inv(world_view)[3, :3]
            scalars = [np.float32(math.tan(msg["fov_x"] * 0.5)),
                       np.float32(math.tan(msg["fov_y"] * 0.5)),
                       np.float32(msg["z_near"]), np.float32(msg["z_far"])]
        except (KeyError, TypeError, ValueError):  # JSON, Unicode and LinAlg errors too
            traceback.print_exc()  # a malformed message: no frame, the connection stays
            return None, (0, 0), None, None, None, None
        cam = CameraArrays(*(torch.as_tensor(a, dtype=torch.float32, device=self.device)
                             for a in (world_view, full_proj, cam_center, *scalars)))
        return cam, (width, height), do_training, keep_alive, scaling_modifier, render_mode

    def serve(self, render, verify: str, metrics: dict) -> tuple:
        """Answer one request of the connected client: receive it, render
        its camera with `render(cam, width, height, scaling_modifier)` (a
        render package), put that through the client's render mode, and send
        the frame with `verify` and `metrics`. A request without a camera gets
        no image. Returns the client's (do_training, keep_alive)."""
        cam, (w, h), do_training, keep_alive, scaling_modifier, mode = self.receive()
        image_bytes = None
        if cam is not None:
            frame = render_net_image(render(cam, w, h, scaling_modifier), self.render_items, mode)
            image_bytes = image_to_bytes(frame)
        self.send(image_bytes, verify, metrics)
        return do_training, keep_alive

    def send(self, image_bytes: Optional[bytes], verify: str, metrics: dict) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(struct.pack("<I", len(verify)))
        self.conn.sendall(verify.encode("ascii"))
        self._send_json(metrics)

    def disconnect(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def close(self) -> None:
        """Drop the client and stop listening."""
        self.disconnect()
        if self.listener is not None:
            self.listener.close()
            self.listener = None


class Follower:
    """The viewer of a rank other than 0 under a mesh: rank 0 owns the
    socket and serves the client; this rank follows the words it
    broadcasts (`Trainer(gui=Follower())` on every rank but 0)."""

    def __repr__(self) -> str:
        return "Follower()"


def request_word(code: int, cam: Optional[CameraArrays] = None, width: int = 0,
                 height: int = 0, scaling_modifier: float = 1.0) -> torch.Tensor:
    """`code` and a request as one float64 vector in host memory (a zero
    camera when `cam` is None)."""
    word = torch.zeros(WORD_LEN, dtype=torch.float64)
    word[:4] = torch.tensor([code, width, height, scaling_modifier], dtype=torch.float64)
    if cam is not None:
        word[4:] = torch.cat([a.detach().reshape(-1).to("cpu", torch.float64) for a in cam])
    return word


def read_request(word: torch.Tensor) -> tuple:
    """(camera in host memory, width, height, scaling modifier) of a
    `request_word`; its code is `int(word[0])`."""
    _, width, height, scaling_modifier = word[:4].tolist()
    f32 = word[4:].to(torch.float32)
    cam = CameraArrays(f32[0:16].reshape(4, 4), f32[16:32].reshape(4, 4), f32[32:35],
                       *f32[35:39].unbind())
    return cam, int(width), int(height), scaling_modifier


def image_to_bytes(chw) -> bytes:
    """(3,H,W) float [0,1] -> raw HWC u8 bytes (the viewer's frame format).

    Cut to u8 on the image's device, so a frame on the GPU copies 1 byte a
    channel to the host, not 4. The bytes equal numpy's
    (clip(x, 0, 1) * 255).astype(uint8): a float32 product, truncated."""
    x = torch.as_tensor(chw)
    u8 = (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
    return u8.permute(1, 2, 0).contiguous().cpu().numpy().tobytes()
