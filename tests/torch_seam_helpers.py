"""What the port's checker tests share: the JAX package's seam taken off
for a test.

The port's seam refuses to install while another seam has patched
``threading``.  Under a session that installed the JAX package's checkers
(``WEED_LOCKCHECK=1`` or ``WEED_RACECHECK=1`` in tests/conftest.py), the
port's checker tests take the JAX seam's patches off for the test and put
them back after, so they run in that session too.
"""

from __future__ import annotations

import pytest

from seaweedfs_tpu.util import sync_seam as jax_sync_seam


@pytest.fixture(autouse=True)
def no_jax_seam():
    held = set(jax_sync_seam._components)
    for component in held:
        jax_sync_seam.uninstall(component)
    yield
    for component in held:
        jax_sync_seam.install(component)
