"""IAM query API: AWS-IAM-shaped user/access-key management over HTTP.

Counterpart of the reference's weed/iamapi/ (iamapi_management_handlers.go):
form-encoded ``Action=`` requests (the AWS IAM query protocol) mutating a
CredentialStore, XML responses.  Supported actions: CreateUser, GetUser,
DeleteUser, ListUsers, CreateAccessKey, DeleteAccessKey, ListAccessKeys.
The S3 gateway watching the same store picks up changes within its
refresh interval — no restarts.

The port's copy of seaweedfs_tpu/iam/iam_api.py.
"""

from __future__ import annotations

import threading
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from seaweedfs_tpu_torch.iam.credentials import CredentialStore
from seaweedfs_tpu_torch.util.httpd import PooledHTTPServer, QuietHandler

XMLNS = "https://iam.amazonaws.com/doc/2010-05-08/"


def _resp(action: str, fill) -> bytes:
    root = ET.Element(f"{action}Response", xmlns=XMLNS)
    result = ET.SubElement(root, f"{action}Result")
    fill(result)
    meta = ET.SubElement(root, "ResponseMetadata")
    ET.SubElement(meta, "RequestId").text = uuid.uuid4().hex
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def _error(status: int, code: str, message: str) -> tuple[int, bytes]:
    root = ET.Element("ErrorResponse", xmlns=XMLNS)
    err = ET.SubElement(root, "Error")
    ET.SubElement(err, "Code").text = code
    ET.SubElement(err, "Message").text = message
    return status, b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


class _IamHandler(QuietHandler):
    iam: "IamApiServer" = None

    def do_POST(self):
        length = int(self.headers.get("Content-Length", "0") or 0)
        raw = self.rfile.read(length)
        # once any identity exists, mutations must be signed by one —
        # an open key-minting endpoint would defeat the S3 gateway's
        # auth entirely.  Empty store = bootstrap mode (first admin).
        import hashlib as _hashlib

        from seaweedfs_tpu_torch.s3.auth import AccessDenied, SigV4Verifier

        idents = self.iam.store.identity_map()
        if idents:
            url = urllib.parse.urlparse(self.path)
            try:
                SigV4Verifier(idents).verify(
                    self.command,
                    url.path,
                    url.query,
                    self.headers,
                    _hashlib.sha256(raw).hexdigest(),
                )
            except AccessDenied as e:
                status, body = _error(403, "AccessDenied", str(e))
                self._reply(status, body, "text/xml")
                return
        form = urllib.parse.parse_qs(raw.decode())
        action = form.get("Action", [""])[0]
        handler = getattr(self, f"_do_{action}", None)
        if handler is None:
            status, body = _error(400, "InvalidAction", f"unsupported {action!r}")
        else:
            try:
                status, body = handler(form)
            except KeyError as e:
                status, body = _error(404, "NoSuchEntity", f"no such user {e}")
            except ValueError as e:
                status, body = _error(409, "EntityAlreadyExists", str(e))
        self._reply(status, body, "text/xml")

    # ---- actions ---------------------------------------------------------
    def _do_CreateUser(self, form):
        name = form.get("UserName", [""])[0]
        if not name:
            return _error(400, "InvalidInput", "UserName required")
        user = self.iam.store.create_user(name)

        def fill(r):
            u = ET.SubElement(r, "User")
            ET.SubElement(u, "UserName").text = user.name
            ET.SubElement(u, "UserId").text = user.name

        return 200, _resp("CreateUser", fill)

    def _do_GetUser(self, form):
        name = form.get("UserName", [""])[0]
        users = self.iam.store.load()
        if name not in users:
            raise KeyError(name)

        def fill(r):
            u = ET.SubElement(r, "User")
            ET.SubElement(u, "UserName").text = name

        return 200, _resp("GetUser", fill)

    def _do_DeleteUser(self, form):
        self.iam.store.delete_user(form.get("UserName", [""])[0])
        # a deleted user's keys must stop signing immediately, same as
        # an explicit key revocation
        self.iam.notify_changed()
        return 200, _resp("DeleteUser", lambda r: None)

    def _do_ListUsers(self, form):
        users = self.iam.store.load()

        def fill(r):
            lst = ET.SubElement(r, "Users")
            for name in sorted(users):
                u = ET.SubElement(lst, "member")
                ET.SubElement(u, "UserName").text = name

        return 200, _resp("ListUsers", fill)

    def _do_CreateAccessKey(self, form):
        name = form.get("UserName", [""])[0]
        ak, sk = self.iam.store.create_access_key(name)
        self.iam.notify_changed()

        def fill(r):
            k = ET.SubElement(r, "AccessKey")
            ET.SubElement(k, "UserName").text = name
            ET.SubElement(k, "AccessKeyId").text = ak
            ET.SubElement(k, "SecretAccessKey").text = sk
            ET.SubElement(k, "Status").text = "Active"

        return 200, _resp("CreateAccessKey", fill)

    def _do_DeleteAccessKey(self, form):
        self.iam.store.delete_access_key(
            form.get("UserName", [""])[0], form.get("AccessKeyId", [""])[0]
        )
        self.iam.notify_changed()
        return 200, _resp("DeleteAccessKey", lambda r: None)

    def _do_ListAccessKeys(self, form):
        name = form.get("UserName", [""])[0]
        users = self.iam.store.load()
        if name not in users:
            raise KeyError(name)

        def fill(r):
            lst = ET.SubElement(r, "AccessKeyMetadata")
            for ak, _sk in users[name].keys:
                m = ET.SubElement(lst, "member")
                ET.SubElement(m, "UserName").text = name
                ET.SubElement(m, "AccessKeyId").text = ak
                ET.SubElement(m, "Status").text = "Active"

        return 200, _resp("ListAccessKeys", fill)


class IamApiServer:
    def __init__(
        self,
        store: CredentialStore,
        *,
        port: int = 0,
        ip: str = "127.0.0.1",
        on_change=None,  # e.g. the S3 gateway's refresh hook
    ):
        self.store = store
        self.ip = ip
        self._port = port
        self.on_change = on_change
        self._httpd: PooledHTTPServer | None = None

    def notify_changed(self) -> None:
        if self.on_change is not None:
            self.on_change()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> None:
        handler = type("Handler", (_IamHandler,), {"iam": self})
        self._httpd = PooledHTTPServer((self.ip, self._port), handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
