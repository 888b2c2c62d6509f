"""OAuth2 sign-in providers (google / github authorization-code flow).

Reference counterpart: manager/auth/oauth/oauth.go (the Oauth interface:
AuthCodeURL / Exchange / GetUser), google.go and github.go (provider
endpoints + userinfo mapping), with provider configs CRUD-stored in the
database (manager/models/oauth.go, manager/service/oauth.go) and wired to
``GET /api/v1/users/signin/{name}[/callback]`` (manager/router/router.go:104).

Stdlib only (urllib). Provider endpoint URLs are constructor arguments
with the real defaults so tests can point a provider at a faked identity
server — the flow logic under test is exactly the production path.
"""

from __future__ import annotations

import json
import secrets
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Optional

TIMEOUT_S = 120.0  # oauth.go: timeout = 2 * time.Minute

GOOGLE = "google"
GITHUB = "github"

# github.go githubScopes / google.go googleScopes
GITHUB_SCOPES = ["user", "public_repo"]
GOOGLE_SCOPES = [
    "https://www.googleapis.com/auth/userinfo.email",
    "https://www.googleapis.com/auth/userinfo.profile",
]


class OAuthError(Exception):
    pass


@dataclass(frozen=True)
class OAuthUser:
    """oauth.go's User{Name, Email, Avatar} plus ``subject`` — the
    provider-STABLE unique id (github numeric id, google sub). Display
    names are attacker-chosen free text; account linking must key on
    the subject, never the name."""
    name: str
    email: str
    avatar: str
    subject: str


class OAuth2Provider:
    """Authorization-code flow against one identity provider."""

    name = "generic"
    scopes: list = []

    def __init__(self, client_id: str, client_secret: str, redirect_url: str,
                 *, auth_url: str, token_url: str, userinfo_url: str,
                 timeout: float = TIMEOUT_S):
        self.client_id = client_id
        self.client_secret = client_secret
        self.redirect_url = redirect_url
        self.auth_url = auth_url
        self.token_url = token_url
        self.userinfo_url = userinfo_url
        self.timeout = timeout

    # -- flow steps ------------------------------------------------------

    def auth_code_url(self, state: Optional[str] = None) -> str:
        """The browser-redirect URL; ``state`` is the CSRF nonce (random
        per request, like github.go:50's rand.Read)."""
        params = {
            "client_id": self.client_id,
            "redirect_uri": self.redirect_url,
            "response_type": "code",
            "scope": " ".join(self.scopes),
            "state": state or secrets.token_urlsafe(16),
        }
        return f"{self.auth_url}?{urllib.parse.urlencode(params)}"

    def exchange(self, code: str) -> str:
        """Authorization code → access token at the provider's token
        endpoint (oauth2.Config.Exchange)."""
        body = urllib.parse.urlencode({
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "code": code,
            "grant_type": "authorization_code",
            "redirect_uri": self.redirect_url,
        }).encode()
        req = urllib.request.Request(
            self.token_url, data=body, method="POST",
            headers={"Accept": "application/json",
                     "Content-Type": "application/x-www-form-urlencoded"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
        except (urllib.error.URLError, json.JSONDecodeError) as exc:
            raise OAuthError(f"token exchange failed: {exc}") from exc
        token = payload.get("access_token", "")
        if not token:
            raise OAuthError(
                f"token exchange rejected: {payload.get('error', payload)}")
        return token

    def get_user(self, token: str) -> OAuthUser:
        req = urllib.request.Request(
            self.userinfo_url,
            headers={"Authorization": f"Bearer {token}",
                     "Accept": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
        except (urllib.error.URLError, json.JSONDecodeError) as exc:
            raise OAuthError(f"userinfo fetch failed: {exc}") from exc
        return self._map_user(payload)

    def _map_user(self, payload: dict) -> OAuthUser:
        raise NotImplementedError

    @staticmethod
    def _require(payload: dict, *keys: str) -> str:
        for key in keys:
            value = payload.get(key)
            if value:
                return str(value)
        raise OAuthError(f"userinfo missing {'/'.join(keys)}: {payload}")


class GoogleOAuth(OAuth2Provider):
    """google.go: endpoints from oauth2/google, userinfo v2 ``me``."""

    name = GOOGLE
    scopes = GOOGLE_SCOPES

    def __init__(self, client_id: str, client_secret: str, redirect_url: str,
                 *, auth_url: str = "https://accounts.google.com/o/oauth2/auth",
                 token_url: str = "https://oauth2.googleapis.com/token",
                 userinfo_url: str = "https://www.googleapis.com/oauth2/v2/userinfo",
                 timeout: float = TIMEOUT_S):
        super().__init__(client_id, client_secret, redirect_url,
                         auth_url=auth_url, token_url=token_url,
                         userinfo_url=userinfo_url, timeout=timeout)

    def _map_user(self, payload: dict) -> OAuthUser:
        return OAuthUser(
            name=self._require(payload, "name", "email"),
            email=self._require(payload, "email"),
            avatar=str(payload.get("picture", "")),
            # 'sub'/'id' are Google's immutable account ids; email is
            # the verified fallback — never the display name.
            subject=self._require(payload, "sub", "id", "email"),
        )


class GithubOAuth(OAuth2Provider):
    """github.go: endpoints from oauth2/github, ``/user`` userinfo."""

    name = GITHUB
    scopes = GITHUB_SCOPES

    def __init__(self, client_id: str, client_secret: str, redirect_url: str,
                 *, auth_url: str = "https://github.com/login/oauth/authorize",
                 token_url: str = "https://github.com/login/oauth/access_token",
                 userinfo_url: str = "https://api.github.com/user",
                 timeout: float = TIMEOUT_S):
        super().__init__(client_id, client_secret, redirect_url,
                         auth_url=auth_url, token_url=token_url,
                         userinfo_url=userinfo_url, timeout=timeout)

    def _map_user(self, payload: dict) -> OAuthUser:
        return OAuthUser(
            name=self._require(payload, "name", "login"),
            email=str(payload.get("email", "")),
            avatar=str(payload.get("avatar_url", "")),
            # GitHub's numeric id is immutable (logins can be renamed
            # and re-registered; display names are free text).
            subject=self._require(payload, "id", "login"),
        )


_PROVIDERS = {GOOGLE: GoogleOAuth, GITHUB: GithubOAuth}


def new_provider(name: str, client_id: str, client_secret: str,
                 redirect_url: str, **endpoint_overrides) -> OAuth2Provider:
    """oauth.go's New(): name → provider, error on unknown names.
    ``endpoint_overrides`` (auth_url/token_url/userinfo_url) point tests
    at a faked identity server."""
    cls = _PROVIDERS.get(name)
    if cls is None:
        raise OAuthError(f"invalid oauth name {name!r}")
    overrides = {k: v for k, v in endpoint_overrides.items() if v}
    return cls(client_id, client_secret, redirect_url, **overrides)
