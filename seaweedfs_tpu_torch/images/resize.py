"""On-the-fly resizing: the port's copy of seaweedfs_tpu/images/resize.py's
``resize_image`` (the JAX module's EXIF-only ``fix_orientation`` has no
caller in the port).

Counterpart of the reference's weed/images/ (resizing.go Resized:
?width/?height/?mode=fit|fill on needle GETs; a JPEG's EXIF orientation is
applied first).  Pillow does the pixel work; unsupported or
non-image payloads pass through untouched, like the reference.  Pillow
is optional: without it every image is served as stored.
"""

from __future__ import annotations

import io

from seaweedfs_tpu_torch.util import wlog

_FORMATS = {"image/jpeg": "JPEG", "image/png": "PNG", "image/gif": "GIF"}


def _sniff(data: bytes) -> str | None:
    if data[:3] == b"\xff\xd8\xff":
        return "image/jpeg"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "image/png"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "image/gif"
    return None


def resize_image(
    data: bytes, width: int = 0, height: int = 0, mode: str = "fit"
) -> tuple[bytes, str]:
    """Resize to (width, height); 0 keeps aspect from the other side.

    mode "fit" letterboxes inside the box (aspect preserved), "fill"
    center-crops to exactly the box (reference resizing.go modes).
    Returns (bytes, mime); non-images or no-op dimensions pass through.
    """
    mime = _sniff(data)
    if mime is None or (width <= 0 and height <= 0):
        return data, mime or "application/octet-stream"
    try:
        from PIL import Image, ImageOps

        img = Image.open(io.BytesIO(data))
        if mime == "image/jpeg":
            img = ImageOps.exif_transpose(img)
        w0, h0 = img.size
        if width <= 0:
            width = max(1, w0 * height // h0)
        if height <= 0:
            height = max(1, h0 * width // w0)
        if mode == "fill":
            img = ImageOps.fit(img, (width, height))
        else:
            img.thumbnail((width, height))
        out = io.BytesIO()
        save_kwargs = {"quality": 90} if mime == "image/jpeg" else {}
        img.save(out, format=_FORMATS[mime], **save_kwargs)
        return out.getvalue(), mime
    except Exception as e:  # noqa: BLE001 — undecodable: serve the original
        if wlog.V(2):
            wlog.info("images: resize failed, serving original: %s", e)
        return data, mime
