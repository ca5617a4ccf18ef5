"""The rendezvous store: the store half of the JAX package's
``runtime/native.py`` (:class:`StoreServer` / :class:`StoreClient`), built
on c10d's own ``torch.distributed.TCPStore`` where the JAX package binds
its C++ store (``native/store.cpp``) through ctypes.

Key-value rendezvous with blocking waits, atomic counters and reusable
barriers. The elastic agent (``launch.py``) hosts one for its workers'
heartbeats (``runtime/failure.py``), and the parameter server
(``parallel/ps.py``) sends its parameters and gradients through one.

The same calls and errors as the JAX store: ``get`` waits for its key (a
negative ``timeout_ms`` waits forever) and raises ``TimeoutError`` when
the wait runs out; every other failure of an operation (a server that has
stopped among them) raises ``OSError``, so ``failure.store_call`` sees an
outage and retries it, never a hang. ``set`` is acknowledged by the server
before it returns (c10d's ``set`` sends without a reply, so the client
asks ``check`` on the same connection after it). One difference: a
counter written by ``add`` reads back through ``get`` as c10d's decimal
text (``b"6"``), where the JAX store returns its eight bytes; both read it
the same through ``add(key, 0)``, as every caller does.

Not ported: the chaos hooks of each operation (slice 6, ROADMAP.md §1 item
5) and the data-generation half (``gen_templates``, ``gen_images``,
``gen_lm``), which no path of the JAX package calls (item 5).
"""

from __future__ import annotations

import datetime

import torch.distributed as dist

_FOREVER = datetime.timedelta.max


def _ms(ms: int) -> datetime.timedelta:
    return _FOREVER if ms < 0 else datetime.timedelta(milliseconds=ms)


class StoreServer:
    """Hosts the store (one per job, on the coordinator): c10d's master
    ``TCPStore`` on ``port`` (0 picks a free one; :attr:`port` is the one
    bound). The server runs until :meth:`stop`."""

    def __init__(self, port: int = 0) -> None:
        try:
            self._store = dist.TCPStore("127.0.0.1", port, is_master=True,
                                        wait_for_workers=False)
        except dist.DistError as e:
            raise OSError(f"could not bind store server on port {port}: "
                          f"{e}") from e
        self.port = self._store.port

    def stop(self) -> None:
        """Stop serving: the master store's last reference goes, which
        closes its listening socket and every client connection (a
        client's next operation, or its wait, raises ``OSError``)."""
        self._store = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class StoreClient:
    """One connection to the store; thread-safe per handle (c10d
    serialises a client's operations)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 connect_timeout_ms: int = 30_000) -> None:
        try:
            self._store = dist.TCPStore(
                host, port, is_master=False,
                timeout=_ms(connect_timeout_ms))
        except dist.DistError as e:
            raise ConnectionError(f"could not connect to store at "
                                  f"{host}:{port}: {e}") from e
        self._barrier_round: dict[str, int] = {}

    def _call(self, what: str, fn, *args):
        if self._store is None:
            raise OSError(f"store {what} on a closed client")
        try:
            return fn(*args)
        except dist.DistStoreError as e:  # c10d's wait timeout
            raise TimeoutError(f"store {what} timed out: {e}") from e
        except dist.DistError as e:
            raise OSError(f"store {what} failed: {e}") from e

    def set(self, key: str, value: bytes) -> None:
        def acked_set():
            self._store.set(key, value)
            self._store.check([key])  # the server's reply: set landed

        self._call(f"set({key!r})", acked_set)

    def get(self, key: str, *, timeout_ms: int = -1) -> bytes:
        """Blocking wait for ``key`` (timeout_ms < 0 waits forever); a
        value of any size (c10d sizes its buffer from the value, where the
        JAX store's ``max_bytes`` grows a receive buffer)."""

        def wait_get():
            self._store.wait([key], _ms(timeout_ms))
            return self._store.get(key)

        return bytes(self._call(f"get({key!r})", wait_get))

    def add(self, key: str, delta: int = 1) -> int:
        return int(self._call(f"add({key!r})", self._store.add, key,
                              delta))

    def check(self, key: str) -> bool:
        return bool(self._call(f"check({key!r})", self._store.check, [key]))

    def delete(self, key: str) -> None:
        self._call(f"delete({key!r})", self._store.delete_key, key)

    def barrier(self, name: str, world_size: int, *,
                timeout_ms: int = 60_000) -> None:
        """c10d-style store barrier: count arrivals, wait for the flag.

        Reusable: each call advances a per-name round (all participants
        must call it the same number of times, the usual contract), so
        per-step/per-epoch barriers don't see stale flags.
        """
        rnd = self._barrier_round.get(name, 0)
        self._barrier_round[name] = rnd + 1
        arrived = self.add(f"__barrier__/{name}/{rnd}/count", 1)
        flag = f"__barrier__/{name}/{rnd}/done"
        if arrived == world_size:
            self.set(flag, b"1")
        else:
            self.get(flag, timeout_ms=timeout_ms)

    def close(self) -> None:
        self._store = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
