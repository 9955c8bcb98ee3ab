# The PyTorch port's own copy of elasticdl_tpu/common/metrics_http.py: the port imports
# nothing of the JAX package.
"""The live metrics plane's reading half: a /metrics + /healthz server.

One of these runs beside every process of a job — master, each worker,
each PS shard, the serving replica — on its OWN daemon threads
(``ThreadingHTTPServer``), never the task loop: a gang wedged inside a
collective, a PS shard blocked in a save, a batcher past its knee must
all still answer a scrape, because the wedge is exactly when the
operator needs the numbers (the r13 chaos stance: the instrument must
survive the failure it exists to show).

Stdlib only (``http.server``): the master control plane and the PS
shards are jax-free by contract, and pulling an HTTP framework in for
two GET routes would be the heaviest import in the process.

Routes:

- ``GET /metrics``  -> Prometheus text (the ``render_fn``, usually a
  ``gauge.Registry.render_prometheus`` bound method — collectors run per
  scrape, so pull-model families are fresh);
- ``GET /healthz``  -> JSON liveness (``health_fn`` -> dict; always
  ``{"status": "ok", ...}`` while the process answers at all — liveness
  is "the scrape thread is alive", not "the job is healthy": health
  judgements belong to the metrics themselves).

Port 0 (the default) binds ephemeral and the caller logs the bound
address — a job's processes share ONE config bus, so a fixed port would
collide the moment two workers land on a host.  Every process logs the
``[graftgauge] serving /metrics on <addr>`` line at startup; benches and
operators discover endpoints from the pod logs exactly as the chaos
bench reads ``[graftchaos]`` audit lines.
"""

from __future__ import annotations

import json
import socket
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("metrics_http")

#: Prometheus text exposition content type.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """Scrape server over a render callable (and an optional health one).

    ``start()`` spawns the accept loop on a daemon thread and returns
    self; ``stop()`` shuts it down.  Handler errors answer 500 with the
    error text — a broken collector must be visible to the scraper, not
    a silent empty page.
    """

    def __init__(
        self,
        render_fn: Callable[[], str],
        health_fn: Optional[Callable[[], Dict]] = None,
        port: int = 0,
        host: str = "0.0.0.0",
    ):
        self._render = render_fn
        self._health = health_fn

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — http.server contract
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._respond_with(outer._render_bytes)
                elif path == "/healthz":
                    self._respond_with(
                        outer._health_bytes, "application/json"
                    )
                else:
                    self.send_error(404, "try /metrics or /healthz")

            def _respond_with(self, fn, ctype: str = CONTENT_TYPE) -> None:
                try:
                    body = fn()
                except Exception as e:  # broken render must be VISIBLE
                    logger.exception("metrics render failed")
                    body = f"render failed: {e}".encode()
                    self.send_response(500)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass  # scrapes every few seconds must not spam the pod log

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        # The address OTHER hosts can dial (the pod-log discovery line):
        # a wildcard bind advertises this host's name — logging
        # "localhost" for a worker pod on another machine would hand the
        # operator an address that points at their own box.
        self._advertise_host = (
            socket.gethostname() if host in ("", "0.0.0.0", "::") else host
        )
        self._thread: Optional[threading.Thread] = None

    def _render_bytes(self) -> bytes:
        return self._render().encode()

    def _health_bytes(self) -> bytes:
        payload = {"status": "ok"}
        if self._health is not None:
            payload.update(self._health() or {})
        return json.dumps(payload, sort_keys=True).encode()

    @property
    def address(self) -> str:
        """Loopback view — for same-process/same-host consumers (the
        benches, in-process tests).  Cross-host discovery uses the
        logged ``advertise_address``."""
        return f"localhost:{self.port}"

    @property
    def advertise_address(self) -> str:
        return f"{self._advertise_host}:{self.port}"

    def start(self) -> "MetricsHTTPServer":
        t = threading.Thread(
            target=self._httpd.serve_forever,
            name="edl-metrics-http",
            daemon=True,
        )
        t.start()
        self._thread = t
        # The discovery line (the [graftchaos] pod-log pattern): with
        # ephemeral ports this is how benches and operators find the
        # endpoint of an out-of-process pod — so it must carry an
        # address reachable from OFF this host.
        logger.info(
            "[graftgauge] serving /metrics on %s", self.advertise_address
        )
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def maybe_start(
    port: int,
    render_fn: Callable[[], str],
    health_fn: Optional[Callable[[], Dict]] = None,
    registry=None,
) -> Optional[MetricsHTTPServer]:
    """The one wiring idiom every main shares: ``port < 0`` = disabled
    (None), else bind-and-start (0 = ephemeral).  A bind failure logs and
    returns None — observability must never take the job down.

    ``registry`` (a ``gauge.Registry``, usually the one behind
    ``render_fn``) additionally installs the locksan contention
    collector (r16): lock acquire counts + wait-time histograms join the
    endpoint as ``edl_lock_acquire_total`` / ``edl_lock_wait_ms`` —
    only once an endpoint exists does anyone pay for recording them."""
    if port < 0:
        return None
    try:
        server = MetricsHTTPServer(
            render_fn, health_fn=health_fn, port=port
        ).start()
        if registry is not None:
            # AFTER the successful bind: a failed endpoint must not leave
            # contention recording permanently on with nobody scraping.
            from elasticdl_tpu_torch.common import gauge

            gauge.install_lock_collector(registry)
            # wiresan unknown-field counts (v8): the
            # edl_wire_unknown_fields_total family is the mixed-version-
            # fleet signal — a newer peer's additive fields, visible on
            # every endpoint.
            gauge.install_wire_collector(registry)
        return server
    except OSError:
        logger.exception(
            "metrics endpoint failed to bind port %d; continuing without",
            port,
        )
        return None


# ---- scrape client (the OTHER end of the endpoint above) ----------------
#
# Stdlib-only, beside the server it reads: tests and chip_smoke.py read a
# replica's launch counts and request counters through it.


def _url(address: str, path: str = "/metrics") -> str:
    if address.startswith(("http://", "https://")):
        base = address.rstrip("/")
        # An explicit path in the URL wins (scraping through a proxy).
        return base if "/" in base.split("//", 1)[1] else base + path
    return f"http://{address}{path}"


def fetch_text(address: str, path: str = "/metrics",
               timeout_s: float = 5.0) -> str:
    with urllib.request.urlopen(_url(address, path), timeout=timeout_s) as r:
        return r.read().decode()


def _parse_labels(body: str) -> Dict[str, str]:
    """``a="b",c="d"`` -> dict.  The renderer never emits quotes/commas
    inside values (labels come from worker ids / phase names), so a
    simple split is exact for our own exposition."""
    out: Dict[str, str] = {}
    for part in body.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip().strip('"')
    return out


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Prometheus text -> ``{family: {"type", "help", "samples": [
    {"name", "labels", "value"}]}}`` — the inverse of
    ``gauge.render_families`` (histogram ``_bucket``/``_sum``/``_count``
    series stay flat samples under their family).  Malformed lines are
    skipped: this parses OUR renderer's output, but a scrape racing a
    process exit may truncate mid-line."""
    families: Dict[str, dict] = {}

    def fam(name: str) -> dict:
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[: -len(suffix)] in families:
                base = base[: -len(suffix)]
                break
        return families.setdefault(
            base, {"type": "untyped", "help": "", "samples": []}
        )

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):].split(" ", 1)
            fam(rest[0])["help"] = rest[1] if len(rest) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):].split(" ", 1)
            fam(rest[0])["type"] = rest[1].strip() if len(rest) > 1 else ""
            continue
        if line.startswith("#"):
            continue
        try:
            metric, value_s = line.rsplit(" ", 1)
            value = float(value_s)
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        name = metric
        if "{" in metric and metric.endswith("}"):
            name, body = metric.split("{", 1)
            labels = _parse_labels(body[:-1])
        fam(name)["samples"].append(
            {"name": name, "labels": labels, "value": value}
        )
    return families


def fetch(address: str, timeout_s: float = 5.0) -> Dict[str, dict]:
    """One scrape, parsed — the programmatic entry (benches stamp this as
    their ``live_metrics`` snapshot; the fleet controller reads its knee
    signal from it)."""
    return parse_prometheus(fetch_text(address, timeout_s=timeout_s))
