"""``python -m seaweedfs_tpu_torch.weedrace`` entry point."""

from seaweedfs_tpu_torch.weedrace.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
