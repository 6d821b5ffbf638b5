"""Repo-local test CA: self-signed certificates for the TLS transports.

Drives the ``openssl`` CLI (no Python dependency) to mint a throwaway
certificate authority plus per-agent EC certificates, so TLS'd
deployments — and CI — never need real PKI. Every leaf certificate
carries the SAN list the :class:`~repro_torch.comm.base.TLSSpec` hostname
check verifies against (``localhost`` + ``127.0.0.1`` by default; pass
the real hostnames/IPs for multi-machine runs).

Library use::

    from repro_torch.launch.certs import TestCA

    ca = TestCA("certs")                     # creates ca.crt / ca.key
    spec = ca.tls_spec("master")             # issues master.crt/.key
    job = VFLJob(cfg, master, members, mode="grpc",
                 comm_cfg=CommCfg(tls=spec))

CLI (what the docs/deploy.md walkthrough and the CI cluster job run)::

    python -m repro_torch.launch.certs --dir certs \\
        --agents master member0 alpha beta --hosts localhost 127.0.0.1

These certificates are for testing and benchmarking only — production
deployments should use organization-issued certificates; the
``TLSSpec`` consumes any PEM chain.
"""
from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
from typing import Optional, Sequence, Tuple

from repro_torch.comm.base import TLSSpec

DEFAULT_HOSTS = ("localhost", "127.0.0.1")


def have_openssl() -> bool:
    """Is the ``openssl`` CLI on PATH? (Tests skip TLS cases if not.)"""
    return shutil.which("openssl") is not None


def _run(*args: str) -> None:
    proc = subprocess.run(["openssl", *args], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"openssl {' '.join(args[:2])} failed:\n"
                           f"{proc.stderr.strip()}")


def _san(hosts: Sequence[str]) -> str:
    parts = []
    for h in hosts:
        kind = "IP" if h.replace(".", "").replace(":", "").isdigit() \
            or ":" in h else "DNS"
        parts.append(f"{kind}:{h}")
    return "subjectAltName=" + ",".join(parts)


class TestCA:
    """A directory-backed throwaway CA issuing per-agent certificates.

    The CA keypair is created on first use and reused afterwards, so
    repeated calls (e.g. every pytest session) are cheap; issued leaf
    certificates are cached by name. Keys are prime256v1 EC (fast to
    generate, universally supported by ``ssl``).

    Example::

        ca = TestCA("/tmp/certs", hosts=("localhost", "127.0.0.1"))
        cert, key = ca.issue("member0")
        spec = ca.tls_spec("member0")    # TLSSpec(cert, key, ca.crt)
    """

    __test__ = False          # not a pytest class, despite the name

    def __init__(self, directory, hosts: Sequence[str] = DEFAULT_HOSTS):
        if not have_openssl():
            raise RuntimeError("the openssl CLI is required to mint "
                               "test certificates")
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.hosts = tuple(hosts)
        self.ca_cert = str(self.dir / "ca.crt")
        self.ca_key = str(self.dir / "ca.key")
        if not (self.dir / "ca.crt").exists():
            _run("ecparam", "-name", "prime256v1", "-genkey", "-noout",
                 "-out", self.ca_key)
            _run("req", "-x509", "-new", "-key", self.ca_key, "-out",
                 self.ca_cert, "-days", "3650", "-sha256", "-subj",
                 "/CN=repro-test-ca")
            # a fresh CA invalidates any leaves left from a previous
            # one — drop them so issue() regenerates under this CA
            # instead of reusing certificates that no longer chain
            for leaf in self.dir.glob("*.crt"):
                if leaf.name != "ca.crt":
                    leaf.unlink()

    def issue(self, name: str,
              hosts: Optional[Sequence[str]] = None) -> Tuple[str, str]:
        """Issue (or reuse) a certificate for agent ``name``; returns
        ``(cert_path, key_path)``. ``hosts`` lists the SAN entries the
        peer's hostname check must accept. A cached certificate is
        reused only when its recorded SAN list matches — re-minting
        with new hostnames (e.g. moving from localhost to real
        machines) regenerates instead of silently handing back a stale
        localhost-only certificate."""
        cert = self.dir / f"{name}.crt"
        key = self.dir / f"{name}.key"
        ext = self.dir / f"{name}.ext"     # kept: records the SAN list
        san = _san(hosts or self.hosts) + "\n"
        if not cert.exists() or not ext.exists() \
                or ext.read_text() != san:
            csr = self.dir / f"{name}.csr"
            ext.write_text(san)
            _run("ecparam", "-name", "prime256v1", "-genkey", "-noout",
                 "-out", str(key))
            _run("req", "-new", "-key", str(key), "-out", str(csr),
                 "-subj", f"/CN={name}")
            _run("x509", "-req", "-in", str(csr), "-CA", self.ca_cert,
                 "-CAkey", self.ca_key, "-CAcreateserial", "-out",
                 str(cert), "-days", "825", "-sha256", "-extfile",
                 str(ext))
            csr.unlink()
        return str(cert), str(key)

    def tls_spec(self, name: str,
                 hosts: Optional[Sequence[str]] = None,
                 server_hostname: Optional[str] = None,
                 check_hostname: bool = True) -> TLSSpec:
        """Issue a certificate for ``name`` and wrap it in a ready
        :class:`~repro_torch.comm.base.TLSSpec` trusting this CA."""
        cert, key = self.issue(name, hosts)
        return TLSSpec(cert=cert, key=key, ca=self.ca_cert,
                       server_hostname=server_hostname,
                       check_hostname=check_hostname)

    def templated_spec(self, server_hostname: Optional[str] = None,
                       check_hostname: bool = True) -> TLSSpec:
        """A :class:`TLSSpec` with ``{agent}`` placeholder paths — one
        spec shared by every agent, each resolving its own issued
        certificate (the shape cluster specs and ``VFLJob`` use)."""
        return TLSSpec(cert=str(self.dir / "{agent}.crt"),
                       key=str(self.dir / "{agent}.key"),
                       ca=self.ca_cert,
                       server_hostname=server_hostname,
                       check_hostname=check_hostname)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.certs",
        description="Mint a test CA + per-agent TLS certificates "
                    "(testing only — not production PKI).")
    ap.add_argument("--dir", default="certs",
                    help="output directory (default: ./certs)")
    ap.add_argument("--agents", nargs="+", required=True,
                    help="certificate names to issue (agent ids and "
                         "launcher host names)")
    ap.add_argument("--hosts", nargs="+", default=list(DEFAULT_HOSTS),
                    help="SAN hostnames/IPs every certificate is valid "
                         "for (default: localhost 127.0.0.1)")
    args = ap.parse_args(argv)
    ca = TestCA(args.dir, hosts=args.hosts)
    for name in args.agents:
        cert, _ = ca.issue(name)
        print(f"issued {cert}")
    print(f"CA at {ca.ca_cert}; point TLSSpec.ca (and [comm.tls] in "
          f"cluster specs) at it")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
