"""Privilege store: users, grants, and mysql_native_password auth.

Counterpart of tidb_tpu/utils/privilege.py. Reference:
pkg/privilege/privileges/cache.go (MySQLPrivilege — the in-memory cache
of mysql.user / mysql.db / mysql.tables_priv) and the auth check at
connection time (pkg/server handshake + pkg/parser/auth). The engine
keeps the same three grant scopes — global (*.*), database (db.*), table
(db.t) — in a plain dict on the catalog; the wire-auth math is the
standard mysql_native_password scramble. Cut to what a server and its
sessions read: CREATE USER, DROP USER, GRANT and REVOKE's store
operations, authentication, the checks and SHOW GRANTS' lines;
persisting the store belongs to a later slice.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Set

from tidb_tpu_torch.utils import racecheck

#: grantable privileges (subset of the reference's Priv bitmask,
#: pkg/parser/mysql/privs.go)
PRIVS = {
    "select", "insert", "update", "delete", "create", "drop",
    "index", "alter",
}


def password_hash(password: str) -> bytes:
    """SHA1(SHA1(password)) — what mysql.user stores for
    mysql_native_password (authentication_string)."""
    return hashlib.sha1(hashlib.sha1(password.encode()).digest()).digest()


def check_native_password(
    scramble: bytes, auth_response: bytes, stored: Optional[bytes]
) -> bool:
    """Verify a mysql_native_password handshake response.

    Client sends SHA1(pw) XOR SHA1(scramble + SHA1(SHA1(pw))); the server
    holds H2 = SHA1(SHA1(pw)) and checks SHA1(response XOR SHA1(scramble
    + H2)) == H2."""
    if stored is None:  # empty password account
        return len(auth_response) == 0
    if len(auth_response) != 20:
        return False
    mask = hashlib.sha1(scramble + stored).digest()
    sha1_pw = bytes(a ^ b for a, b in zip(auth_response, mask))
    return hashlib.sha1(sha1_pw).digest() == stored


class UserStore:
    """Users + grants. Thread-safe (the server authenticates concurrent
    connections against it)."""

    def __init__(self):
        self._lock = racecheck.make_lock("privilege")
        # user -> {"password": sha1sha1 bytes | None, "grants":
        #          {(db|'*', table|'*'): set of privs | {'all'}}}
        self.users: Dict[str, Dict] = {
            "root": {"password": None, "grants": {("*", "*"): {"all"}}}
        }

    # -- administration ------------------------------------------------
    def create_user(
        self, name: str, password: str = "", if_not_exists: bool = False
    ) -> None:
        name = name.lower()
        with self._lock:
            if name in self.users:
                if if_not_exists:
                    return
                raise ValueError(f"user {name!r} already exists")
            self.users[name] = {
                "password": password_hash(password) if password else None,
                "grants": {},
            }

    def drop_user(self, name: str, if_exists: bool = False) -> None:
        name = name.lower()
        with self._lock:
            if name not in self.users:
                if if_exists:
                    return
                raise ValueError(f"unknown user {name!r}")
            if name == "root":
                raise ValueError("cannot drop root")
            del self.users[name]

    def grant(
        self, privs: Set[str], db: str, table: str, user: str
    ) -> None:
        user = user.lower()
        bad = {p for p in privs if p not in PRIVS and p != "all"}
        if bad:
            raise ValueError(f"unknown privileges {sorted(bad)}")
        with self._lock:
            if user not in self.users:
                raise ValueError(f"unknown user {user!r}")
            scope = (db.lower(), table.lower())
            g = self.users[user]["grants"].setdefault(scope, set())
            g |= privs

    def revoke(
        self, privs: Set[str], db: str, table: str, user: str
    ) -> None:
        user = user.lower()
        bad = {p for p in privs if p not in PRIVS and p != "all"}
        if bad:
            raise ValueError(f"unknown privileges {sorted(bad)}")
        with self._lock:
            if user not in self.users:
                raise ValueError(f"unknown user {user!r}")
            scope = (db.lower(), table.lower())
            g = self.users[user]["grants"].get(scope)
            if g:
                if "all" in privs:
                    g.clear()
                else:
                    if "all" in g:
                        # expand ALL so revoking one privilege actually
                        # removes it (not a silent no-op)
                        g.discard("all")
                        g |= PRIVS
                    g -= privs

    # -- checks --------------------------------------------------------
    def authenticate(
        self, user: str, scramble: bytes, auth_response: bytes
    ) -> bool:
        with self._lock:
            u = self.users.get(user.lower())
        if u is None:
            return False
        return check_native_password(scramble, auth_response, u["password"])

    def check(self, user: str, priv: str, db: str, table: str = "*") -> bool:
        """Does `user` hold `priv` on db.table (via table, db, or global
        scope)? information_schema is readable by everyone (reference:
        virtual memtables skip privilege checks for basic reads)."""
        if db.lower() == "information_schema" and priv == "select":
            return True
        with self._lock:
            u = self.users.get(user.lower())
            if u is None:
                return False
            for scope in (
                ("*", "*"),
                (db.lower(), "*"),
                (db.lower(), table.lower()),
            ):
                g = u["grants"].get(scope)
                if g and ("all" in g or priv in g):
                    return True
        return False

    def is_super(self, user: str) -> bool:
        with self._lock:
            u = self.users.get(user.lower())
            return bool(u and "all" in u["grants"].get(("*", "*"), set()))

    def show_grants(self, user: str) -> List[str]:
        user = user.lower()
        with self._lock:
            u = self.users.get(user)
            if u is None:
                raise ValueError(f"unknown user {user!r}")
            out = []
            for (db, tbl), privs in sorted(u["grants"].items()):
                if not privs:
                    continue
                pl = (
                    "ALL PRIVILEGES"
                    if "all" in privs
                    else ", ".join(sorted(p.upper() for p in privs))
                )
                out.append(f"GRANT {pl} ON {db}.{tbl} TO '{user}'@'%'")
            if not out:
                out.append(f"GRANT USAGE ON *.* TO '{user}'@'%'")
            return out

    # -- persistence (BACKUP's manifest) -------------------------------
    def to_manifest(self) -> Dict:
        with self._lock:
            return {
                name: {
                    "password": (
                        u["password"].hex() if u["password"] else None
                    ),
                    "grants": [
                        [db, tbl, sorted(privs)]
                        for (db, tbl), privs in u["grants"].items()
                    ],
                }
                for name, u in self.users.items()
            }

    @classmethod
    def from_manifest(cls, m: Dict) -> "UserStore":
        st = cls()
        st.users = {}
        for name, u in m.items():
            st.users[name] = {
                "password": bytes.fromhex(u["password"]) if u["password"] else None,
                "grants": {
                    (db, tbl): set(privs) for db, tbl, privs in u["grants"]
                },
            }
        if "root" not in st.users:
            st.users["root"] = {"password": None, "grants": {("*", "*"): {"all"}}}
        return st
