"""Image operations on the read path (reference weed/images/): on-the-fly
resizing for ?width/?height/?mode GET parameters on the volume server, the
port of seaweedfs_tpu/images."""

from seaweedfs_tpu_torch.images.resize import resize_image

__all__ = ["resize_image"]
