"""Local KMS provider: envelope encryption with a master key on disk.

Counterpart of the reference's weed/kms/local/ (the development/
single-node provider of the reference's KMS seam, weed/kms/kms.go):
GenerateDataKey hands out a fresh 256-bit data key plus that key wrapped
(AES-256-GCM) under a named master key; Decrypt unwraps.  Cloud
providers (aws/gcp/azure/openbao in the reference) implement the same
two calls behind this interface.

The port's copy of seaweedfs_tpu/security/kms.py.
"""

from __future__ import annotations

import json
import os
import secrets
from abc import ABC, abstractmethod
from dataclasses import dataclass

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # gated dep: providers fail on use, module imports
    AESGCM = None


class KmsError(RuntimeError):
    pass


@dataclass
class DataKey:
    key_id: str
    plaintext: bytes  # 32 bytes, used then discarded by the caller
    ciphertext: bytes  # wrapped blob safe to persist


class KmsProvider(ABC):
    @abstractmethod
    def generate_data_key(self, key_id: str = "default") -> DataKey: ...

    @abstractmethod
    def decrypt_data_key(self, key_id: str, ciphertext: bytes) -> bytes: ...


class LocalKms(KmsProvider):
    """Master keys live in one JSON file (0600); data keys are wrapped
    with AES-256-GCM under the named master key."""

    def __init__(self, key_file: str):
        if AESGCM is None:
            raise KmsError(
                "local kms needs the 'cryptography' package for AES-GCM "
                "key wrapping, which is not installed"
            )
        self.path = key_file
        self._keys: dict[str, bytes] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as fh:
                raw = json.load(fh)
            self._keys = {k: bytes.fromhex(v) for k, v in raw.items()}
        except FileNotFoundError:
            self._keys = {}
        except (json.JSONDecodeError, ValueError) as e:
            raise KmsError(f"corrupt key file {self.path}: {e}") from e

    def _save(self) -> None:
        tmp = self.path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as fh:
            json.dump({k: v.hex() for k, v in self._keys.items()}, fh)
        os.replace(tmp, self.path)

    def _master(self, key_id: str) -> bytes:
        key = self._keys.get(key_id)
        if key is None:
            key = secrets.token_bytes(32)  # first use creates the key
            self._keys[key_id] = key
            self._save()
        return key

    def key_exists(self, key_id: str) -> bool:
        return key_id in self._keys

    def create_key(self, key_id: str) -> None:
        """Mint a named master key (operator action, like aws kms
        create-key; SSE-KMS requests must reference an existing key)."""
        self._master(key_id)

    def generate_data_key(self, key_id: str = "default") -> DataKey:
        master = self._master(key_id)
        plaintext = secrets.token_bytes(32)
        nonce = secrets.token_bytes(12)
        wrapped = nonce + AESGCM(master).encrypt(
            nonce, plaintext, key_id.encode()
        )
        return DataKey(key_id=key_id, plaintext=plaintext, ciphertext=wrapped)

    def decrypt_data_key(self, key_id: str, ciphertext: bytes) -> bytes:
        master = self._keys.get(key_id)
        if master is None:
            raise KmsError(f"unknown master key {key_id}")
        try:
            return AESGCM(master).decrypt(
                ciphertext[:12], ciphertext[12:], key_id.encode()
            )
        except Exception as e:  # noqa: BLE001 — InvalidTag and friends
            raise KmsError(f"unwrap failed under {key_id}: {e}") from e


def _read_token_file(path: str) -> str:
    """One-line token file (the `bao login` / `vault login` convention);
    "" when absent/unreadable so the lookup chain keeps going."""
    if not path:
        return ""
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return ""


class OpenBaoKms(KmsProvider):
    """OpenBao/Vault transit-engine provider (reference weed/kms/openbao/):
    data keys come from ``POST /v1/<mount>/datakey/plaintext/<key>`` and
    unwrap via ``POST /v1/<mount>/decrypt/<key>`` — spoken with the
    stdlib over the HTTP API (the etcd-store convention).  Fails fast
    when unreachable.

    Credentials: $BAO_TOKEN / $VAULT_TOKEN (or a token file named by
    $BAO_TOKEN_FILE) is THE way to supply the token — environment and
    files stay out of process listings, shell history, and error
    messages.  The legacy ``?token=...`` spec form still works but is
    discouraged (a spec is the kind of string that ends up in argv,
    configs, and logs) and is never echoed back in errors raised here."""

    def __init__(self, spec: str):
        # openbao://host:8200/<mount> (mount defaults to transit);
        # token from $BAO_TOKEN/$VAULT_TOKEN, a token file, or ?token=
        from urllib.parse import parse_qs, urlparse

        u = urlparse(spec)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 8200
        self.mount = (u.path.strip("/") or "transit")
        q = parse_qs(u.query)
        self.token = (
            q.get("token", [""])[0]
            or os.environ.get("BAO_TOKEN", "")
            or os.environ.get("VAULT_TOKEN", "")
            or _read_token_file(os.environ.get("BAO_TOKEN_FILE", ""))
        )
        if not self.token:
            raise KmsError(
                "openbao kms: no token (use $BAO_TOKEN/$VAULT_TOKEN or "
                "$BAO_TOKEN_FILE; spec ?token=... is discouraged)"
            )
        try:
            self._call("GET", f"/v1/sys/mounts/{self.mount}/tune", None)
        except KmsError as e:
            # a 403 means the server answered: a least-privilege transit
            # token (datakey/decrypt only) cannot read sys/mounts and
            # must still start; real auth failures surface on first use
            if "HTTP 403" not in str(e):
                raise
        except OSError as e:
            raise KmsError(
                f"openbao kms: cannot reach {self.host}:{self.port}: {e}"
            ) from e

    def _call(self, method: str, path: str, payload: dict | None) -> dict:
        from seaweedfs_tpu_torch.util.http_pool import shared_pool

        status, data = shared_pool().request(
            f"{self.host}:{self.port}", method, path,
            body=json.dumps(payload).encode() if payload else None,
            headers={"X-Vault-Token": self.token,
                     "Content-Type": "application/json"},
            timeout=10,
        )
        if status >= 300:
            raise KmsError(
                f"openbao {method} {path}: HTTP {status} {data[:200]!r}"
            )
        return json.loads(data) if data else {}

    def generate_data_key(self, key_id: str = "default") -> DataKey:
        import base64

        doc = self._call(
            "POST", f"/v1/{self.mount}/datakey/plaintext/{key_id}",
            {"bits": 256},
        )["data"]
        return DataKey(
            key_id=key_id,
            plaintext=base64.b64decode(doc["plaintext"]),
            ciphertext=doc["ciphertext"].encode(),  # vault:v1:... token
        )

    def decrypt_data_key(self, key_id: str, ciphertext: bytes) -> bytes:
        import base64

        doc = self._call(
            "POST", f"/v1/{self.mount}/decrypt/{key_id}",
            {"ciphertext": ciphertext.decode()},
        )["data"]
        return base64.b64decode(doc["plaintext"])


class AwsKms(KmsProvider):
    """AWS KMS provider (reference weed/kms/aws/) — gated on boto3."""

    def __init__(self, spec: str = ""):
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise KmsError(
                "aws kms needs the boto3 package (pip install boto3)"
            ) from e
        region = spec.split("://", 1)[1] if "://" in spec else ""
        self.client = boto3.client(
            "kms", **({"region_name": region} if region else {})
        )

    def generate_data_key(self, key_id: str = "default") -> DataKey:
        resp = self.client.generate_data_key(KeyId=key_id, KeySpec="AES_256")
        return DataKey(
            key_id=key_id,
            plaintext=resp["Plaintext"],
            ciphertext=resp["CiphertextBlob"],
        )

    def decrypt_data_key(self, key_id: str, ciphertext: bytes) -> bytes:
        return self.client.decrypt(
            KeyId=key_id, CiphertextBlob=ciphertext
        )["Plaintext"]


class GcpKms(KmsProvider):
    """GCP Cloud KMS provider (reference weed/kms/gcp/) — gated on
    google-cloud-kms.  ``key_id`` is the full key resource name; data
    keys are generated locally and wrapped via the KMS encrypt API (the
    reference does the same — Cloud KMS has no GenerateDataKey)."""

    def __init__(self, spec: str = ""):
        try:
            from google.cloud import kms as gcp_kms  # type: ignore
        except ImportError as e:
            raise KmsError(
                "gcp kms needs the google-cloud-kms package "
                "(pip install google-cloud-kms)"
            ) from e
        self.client = gcp_kms.KeyManagementServiceClient()

    def generate_data_key(self, key_id: str = "default") -> DataKey:
        plaintext = secrets.token_bytes(32)
        resp = self.client.encrypt(
            request={"name": key_id, "plaintext": plaintext}
        )
        return DataKey(
            key_id=key_id, plaintext=plaintext, ciphertext=resp.ciphertext
        )

    def decrypt_data_key(self, key_id: str, ciphertext: bytes) -> bytes:
        return self.client.decrypt(
            request={"name": key_id, "ciphertext": ciphertext}
        ).plaintext


class AzureKms(KmsProvider):
    """Azure Key Vault provider (reference weed/kms/azure/) — gated on
    azure-keyvault-keys; ``spec`` is the vault URL.  Data keys generate
    locally and wrap via the vault key's RSA-OAEP-256 wrap/unwrap (the
    reference's approach)."""

    def __init__(self, spec: str):
        try:
            from azure.identity import DefaultAzureCredential  # type: ignore
            from azure.keyvault.keys.crypto import (  # type: ignore
                CryptographyClient,
                KeyWrapAlgorithm,
            )
        except ImportError as e:
            raise KmsError(
                "azure kms needs azure-keyvault-keys + azure-identity "
                "(pip install azure-keyvault-keys azure-identity)"
            ) from e
        self._vault_url = spec.replace("azure://", "https://", 1)
        self._cred = DefaultAzureCredential()
        self._CryptographyClient = CryptographyClient
        self._alg = KeyWrapAlgorithm.rsa_oaep_256

    def _crypto(self, key_id: str):
        return self._CryptographyClient(
            f"{self._vault_url}/keys/{key_id}", credential=self._cred
        )

    def generate_data_key(self, key_id: str = "default") -> DataKey:
        plaintext = secrets.token_bytes(32)
        wrapped = self._crypto(key_id).wrap_key(self._alg, plaintext)
        return DataKey(
            key_id=key_id, plaintext=plaintext,
            ciphertext=wrapped.encrypted_key,
        )

    def decrypt_data_key(self, key_id: str, ciphertext: bytes) -> bytes:
        return self._crypto(key_id).unwrap_key(self._alg, ciphertext).key


def make_kms(spec: str) -> KmsProvider:
    """KMS factory for the -kms flag / config (reference kms/registry.go
    provider registry):

    - ``local:path.json`` / bare path → LocalKms master-key file
    - ``openbao://host:8200/mount?token=…`` → OpenBao/Vault transit
    - ``aws://[region]``                    → AWS KMS (needs boto3)
    - ``gcp://``                            → GCP Cloud KMS (needs SDK)
    - ``azure://vault.vault.azure.net``     → Azure Key Vault (needs SDK)
    """
    scheme = spec.split("://", 1)[0] if "://" in spec else ""
    if scheme == "openbao" or scheme == "vault":
        return OpenBaoKms(spec)
    if scheme == "aws":
        return AwsKms(spec)
    if scheme == "gcp":
        return GcpKms(spec)
    if scheme == "azure":
        return AzureKms(spec)
    if scheme:
        # unknown scheme: name only the scheme, never the full spec — a
        # mistyped openbao spec carries ?token=... and error strings end
        # up in logs and crash reports
        raise KmsError(f"unknown kms provider scheme {scheme!r}")
    if spec.startswith("local:"):
        return LocalKms(spec[len("local:"):])
    return LocalKms(spec)
