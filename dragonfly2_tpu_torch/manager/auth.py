"""Manager auth: users, JWT sessions, personal access tokens, RBAC.

Reference counterpart: manager/middlewares/jwt.go (appgo/gin-jwt session
tokens), manager/permission/rbac/rbac.go:182 (casbin model: role → object →
read/write), manager/models/user.go + personal_access_token.go, and the
seeded root account (manager/database/database.go seeds user ``root`` with
password ``dragonfly``). OAuth2 sign-in (google/github) lives in
``manager/oauth.py`` (provider flow) + :meth:`AuthService.oauth_signin` /
:meth:`AuthService.oauth_signin_callback` below, mirroring
manager/service/user.go:140-185 (OauthSignin / OauthSigninCallback).

Stdlib only: pbkdf2 for passwords, HMAC-SHA256 JWTs (no external jwt lib).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

from dragonfly2_tpu_torch.manager.database import Database, Row

DEFAULT_ROOT_USER = "root"
DEFAULT_ROOT_PASSWORD = "dragonfly"  # reference seed; change on first login

ROLE_ROOT = "root"
ROLE_GUEST = "guest"

# rbac.go:182 builds per-object permissions; the policy matrix collapses
# to: root = read+write everywhere, guest = read everywhere. Objects are
# the first API path segment (clusters, schedulers, models, jobs, ...).
ROLE_POLICIES: Dict[str, Dict[str, Set[str]]] = {
    ROLE_ROOT: {"*": {"read", "write"}},
    ROLE_GUEST: {"*": {"read"}},
}

_PBKDF2_ITERS = 100_000
_JWT_HEADER = base64.urlsafe_b64encode(
    json.dumps({"alg": "HS256", "typ": "JWT"}).encode()).rstrip(b"=")


class AuthError(Exception):
    pass


def _hash_password(password: str, salt: bytes | None = None) -> str:
    salt = salt or os.urandom(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), salt,
                                 _PBKDF2_ITERS)
    return f"{salt.hex()}${digest.hex()}"


def _check_password(password: str, stored: str) -> bool:
    try:
        salt_hex, digest_hex = stored.split("$", 1)
    except ValueError:
        return False
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 bytes.fromhex(salt_hex), _PBKDF2_ITERS)
    return hmac.compare_digest(digest.hex(), digest_hex)


def _b64(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _unb64(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


@dataclass
class Identity:
    user_id: int
    name: str
    roles: List[str]
    # Non-None for PAT-authenticated requests with declared scopes: the
    # objects the token may touch, enforced before role policy (the
    # reference checks PAT scopes in
    # manager/middlewares/personal_access_token.go).
    scopes: Optional[List[str]] = None

    def can(self, obj: str, action: str) -> bool:
        if (self.scopes is not None
                and obj not in self.scopes and "*" not in self.scopes):
            return False
        for role in self.roles:
            policy = ROLE_POLICIES.get(role, {})
            for scope in (obj, "*"):
                if action in policy.get(scope, ()):
                    return True
        return False


class AuthService:
    def __init__(self, db: Database, secret: str = "",
                 jwt_ttl: float = 7 * 24 * 3600.0,
                 seed_root: bool = True):
        self.db = db
        self.secret = (secret or os.environ.get("DF2_MANAGER_JWT_SECRET", "")
                       or secrets.token_hex(32))
        self.jwt_ttl = jwt_ttl
        self._oauth_states: Dict[str, float] = {}
        if seed_root and self.db.find_one("users", name=DEFAULT_ROOT_USER) is None:
            self.signup(DEFAULT_ROOT_USER, DEFAULT_ROOT_PASSWORD,
                        roles=[ROLE_ROOT])

    # -- users ----------------------------------------------------------

    def signup(self, name: str, password: str, email: str = "",
               roles: List[str] | None = None) -> Row:
        if not name or not password:
            raise AuthError("name and password required")
        if self.db.find_one("users", name=name) is not None:
            raise AuthError(f"user {name!r} exists")
        user_id = self.db.insert(
            "users", name=name, password_hash=_hash_password(password),
            email=email)
        # New self-service accounts get guest (read-only), as the
        # reference's rbac default for non-root users.
        for role in (roles if roles is not None else [ROLE_GUEST]):
            self.db.insert("user_roles", user_id=user_id, role=role)
        return self.db.get("users", user_id)

    def signin(self, name: str, password: str) -> str:
        user = self.db.find_one("users", name=name)
        if user is None or not _check_password(password, user.password_hash):
            raise AuthError("invalid credentials")
        if user.state != "enable":
            raise AuthError("user disabled")
        return self._issue_jwt(user)

    def roles_of(self, user_id: int) -> List[str]:
        return [r.role for r in self.db.find("user_roles", user_id=user_id)]

    def assign_role(self, user_id: int, role: str) -> None:
        if role not in ROLE_POLICIES:
            raise AuthError(f"unknown role {role!r}")
        if self.db.find_one("user_roles", user_id=user_id, role=role) is None:
            self.db.insert("user_roles", user_id=user_id, role=role)

    def revoke_role(self, user_id: int, role: str) -> None:
        row = self.db.find_one("user_roles", user_id=user_id, role=role)
        if row is not None:
            self.db.delete("user_roles", row.id)

    # -- JWT -------------------------------------------------------------

    def _issue_jwt(self, user: Row) -> str:
        now = time.time()
        claims = _b64(json.dumps({
            "sub": user.id, "name": user.name,
            "iat": int(now), "exp": int(now + self.jwt_ttl),
        }).encode())
        signing_input = _JWT_HEADER + b"." + claims
        sig = _b64(hmac.new(self.secret.encode(), signing_input,
                            hashlib.sha256).digest())
        return (signing_input + b"." + sig).decode()

    def verify_jwt(self, token: str) -> Optional[Identity]:
        try:
            header, claims_raw, sig = token.split(".")
            signing_input = f"{header}.{claims_raw}".encode()
            expected = _b64(hmac.new(self.secret.encode(), signing_input,
                                     hashlib.sha256).digest()).decode()
            if not hmac.compare_digest(sig, expected):
                return None
            claims = json.loads(_unb64(claims_raw))
            if claims.get("exp", 0) < time.time():
                return None
            user = self.db.get("users", int(claims["sub"]))
            if user is None or user.state != "enable":
                return None
            return Identity(user.id, user.name, self.roles_of(user.id))
        except (ValueError, KeyError, json.JSONDecodeError):
            return None

    # -- OAuth2 sign-in (user.go:140-185) --------------------------------

    _OAUTH_STATE_TTL = 600.0

    def _oauth_provider(self, name: str):
        from dragonfly2_tpu_torch.manager.oauth import OAuthError, new_provider
        row = self.db.find_one("oauths", name=name)
        if row is None:
            raise AuthError(f"oauth provider {name!r} not configured")
        try:
            return new_provider(
                row.name, row.client_id, row.client_secret, row.redirect_url,
                auth_url=row.auth_url, token_url=row.token_url,
                userinfo_url=row.userinfo_url)
        except OAuthError as exc:
            raise AuthError(str(exc)) from exc

    def _issue_oauth_state(self) -> str:
        now = time.time()
        for state in [s for s, exp in self._oauth_states.items()
                      if exp < now]:
            self._oauth_states.pop(state, None)
        state = secrets.token_urlsafe(16)
        self._oauth_states[state] = now + self._OAUTH_STATE_TTL
        return state

    def _consume_oauth_state(self, state: str) -> bool:
        """One-time use: present, unexpired, then burned. In-memory — a
        multi-replica manager needs sticky routing for the two-leg
        browser flow (same constraint as the reference's session state)."""
        if not state:
            return False
        expiry = self._oauth_states.pop(state, 0)
        return expiry >= time.time()

    def oauth_signin(self, name: str) -> str:
        """GET users/signin/{name}: the provider redirect URL carrying a
        fresh one-time CSRF state (user.go:140 OauthSignin)."""
        return self._oauth_provider(name).auth_code_url(
            self._issue_oauth_state())

    def oauth_signin_callback(self, name: str, code: str,
                              state: str = "") -> str:
        """GET users/signin/{name}/callback?code=...&state=...: verify
        the state, exchange the code, fetch the provider identity,
        find-or-create the local user, and issue a session JWT
        (user.go:154 OauthSigninCallback).

        Account linking keys on (provider, subject) — the provider's
        STABLE unique id (github numeric id, google sub) — never on the
        display name, which is attacker-chosen free text. A display name
        colliding with an existing local account (e.g. a GitHub profile
        renamed to ``root``) gets a fresh, uniquified local user instead
        of the existing one.
        """
        from dragonfly2_tpu_torch.manager.oauth import OAuthError
        if not self._consume_oauth_state(state):
            raise AuthError("invalid or expired oauth state")
        provider = self._oauth_provider(name)
        try:
            token = provider.exchange(code)
            oauth_user = provider.get_user(token)
        except OAuthError as exc:
            raise AuthError(str(exc)) from exc
        user = self.db.find_one("users", oauth_provider=name,
                                oauth_subject=oauth_user.subject)
        if user is None:
            local_name = oauth_user.name
            if self.db.find_one("users", name=local_name) is not None:
                local_name = f"{local_name} ({name}:{oauth_user.subject})"
            if self.db.find_one("users", name=local_name) is not None:
                raise AuthError(f"user {local_name!r} exists")
            # OAuth accounts have no local password: the stored sentinel
            # never matches _check_password's salt$digest shape, so
            # password signin is impossible for them by construction.
            user_id = self.db.insert(
                "users", name=local_name, password_hash="!oauth",
                email=oauth_user.email, oauth_provider=name,
                oauth_subject=oauth_user.subject)
            self.db.insert("user_roles", user_id=user_id, role=ROLE_GUEST)
            user = self.db.get("users", user_id)
        if user.state != "enable":
            raise AuthError("user disabled")
        return self._issue_jwt(user)

    # -- personal access tokens -----------------------------------------

    def create_pat(self, user_id: int, name: str,
                   scopes: List[str] | None = None,
                   ttl: float = 180 * 24 * 3600.0) -> str:
        """Returns the raw token ONCE; only its hash is stored."""
        raw = "dfp_" + secrets.token_urlsafe(32)
        self.db.insert(
            "personal_access_tokens", name=name,
            token_hash=hashlib.sha256(raw.encode()).hexdigest(),
            user_id=user_id, scopes=scopes or [],
            expires_at=time.time() + ttl)
        return raw

    def verify_pat(self, raw: str) -> Optional[Identity]:
        row = self.db.find_one(
            "personal_access_tokens",
            token_hash=hashlib.sha256(raw.encode()).hexdigest())
        if row is None or row.state != "active":
            return None
        if row.expires_at < time.time():
            return None
        user = self.db.get("users", row.user_id)
        if user is None or user.state != "enable":
            return None
        # A token created with scopes grants ONLY those objects; an
        # empty scope list means the owning user's full permissions.
        scopes = list(row.scopes or []) or None
        return Identity(user.id, user.name, self.roles_of(user.id),
                        scopes=scopes)

    def revoke_pat(self, pat_id: int) -> None:
        self.db.update("personal_access_tokens", pat_id, state="revoked")

    # -- request authentication -----------------------------------------

    def authenticate(self, authorization_header: str) -> Optional[Identity]:
        """Bearer JWT or PAT (PATs are prefixed ``dfp_``)."""
        if not authorization_header.startswith("Bearer "):
            return None
        token = authorization_header[len("Bearer "):].strip()
        if token.startswith("dfp_"):
            return self.verify_pat(token)
        return self.verify_jwt(token)
