"""IAM: users, access keys, and the credential stores behind them.

Counterpart of the reference's weed/iamapi/ (the IAM-query
HTTP API) and weed/credential/ (pluggable identity storage: memory,
filer_etc, postgres).  The S3 gateway consumes identities through a
CredentialStore so IAM mutations show up without restarts.

The port's copy of seaweedfs_tpu/iam: the same identity document, actions
and XML.
"""

from seaweedfs_tpu_torch.iam.credentials import (
    CredentialStore,
    FilerEtcCredentialStore,
    MemoryCredentialStore,
    User,
)
from seaweedfs_tpu_torch.iam.iam_api import IamApiServer

__all__ = [
    "CredentialStore",
    "FilerEtcCredentialStore",
    "IamApiServer",
    "MemoryCredentialStore",
    "User",
]
