"""OS preparation (parity with jepsen.os + os/{debian,ubuntu,centos},
`jepsen/src/jepsen/os.clj:4-8` and `os/debian.clj` etc.): hostfile setup,
package installation, and time sync, run once per node before DB setup.

The port's copy of `jepsen_tpu/os_setup.py`.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from . import control as c
from .control import nodeutil as cu
from .control.core import lit

log = logging.getLogger("jepsen_tpu_torch.os")


class OS:
    """os.clj:4-8."""

    def setup(self, test: dict, node: str) -> None:
        return None

    def teardown(self, test: dict, node: str) -> None:
        return None


class Noop(OS):
    """os.clj:10-14."""


noop = Noop


def setup_hostfile(test: dict, node: str) -> None:
    """Write /etc/hosts mapping every test node (os/debian.clj:13-31):
    nodes resolve each other by name even without cluster DNS."""
    from .control import netinfo
    lines = ["127.0.0.1 localhost"]
    for n in test.get("nodes", []):
        try:
            lines.append(f"{netinfo.ip(n)} {n}")
        except Exception:  # noqa: BLE001 - unresolvable in dummy tests
            continue
    content = "\n".join(lines) + "\n"
    with c.su():
        cu.write_file(content, "/etc/hosts")


class Debian(OS):
    """Debian preparation (os/debian.clj:80-205): hostfile, apt packages,
    ntp sync."""

    def __init__(self, packages: Sequence[str] = ()):
        self.packages = list(packages)

    def install(self, pkgs: Sequence[str]) -> None:
        """Install packages unless already present (os/debian.clj:60-80)."""
        if not pkgs:
            return
        with c.su():
            c.exec_(c.env({"DEBIAN_FRONTEND": "noninteractive"}),
                    "apt-get", "install", "-y", "--force-yes", *pkgs)

    def installed(self, pkg: str) -> bool:
        try:
            c.exec_("dpkg", "-s", pkg)
            return True
        except Exception:  # noqa: BLE001
            return False

    def install_jdk(self) -> None:
        """os/debian.clj:153-170."""
        self.install(["openjdk-17-jdk-headless"])

    def setup(self, test, node):
        log.info("Setting up debian on %s", node)
        setup_hostfile(test, node)
        with c.su():
            cu.meh(c.exec_, "apt-get", "update")
        self.install(["curl", "wget", "unzip", "iptables", "psmisc",
                      "tar", "bzip2", "ntpdate", "faketime", "rsyslog",
                      "logrotate"] + self.packages)
        with c.su():
            cu.meh(c.exec_, "service", "ntp", "stop")
            cu.meh(c.exec_, "ntpdate", "-p", "1", "-b",
                   "pool.ntp.org")


debian = Debian


class Ubuntu(Debian):
    """os/ubuntu.clj — identical shape to debian."""


ubuntu = Ubuntu


class CentOS(OS):
    """CentOS preparation (os/centos.clj)."""

    def __init__(self, packages: Sequence[str] = ()):
        self.packages = list(packages)

    def install(self, pkgs: Sequence[str]) -> None:
        if not pkgs:
            return
        with c.su():
            c.exec_("yum", "install", "-y", *pkgs)

    def setup(self, test, node):
        log.info("Setting up centos on %s", node)
        setup_hostfile(test, node)
        self.install(["curl", "wget", "unzip", "iptables", "psmisc",
                      "tar", "bzip2", "ntpdate"] + self.packages)
        with c.su():
            cu.meh(c.exec_, "ntpdate", "-p", "1", "-b", "pool.ntp.org")


centos = CentOS


class SmartOS(OS):
    """SmartOS/illumos preparation (os/smartos.clj:1-96): pkgin
    packages, loopback hostname entry, and the ipfilter-based Net
    backend instead of iptables (net.clj:113-145)."""

    def __init__(self, packages: Sequence[str] = ()):
        self.packages = list(packages)

    def installed(self, pkgs: Sequence[str]) -> set:
        """Subset of `pkgs` already installed (smartos.clj:46-58)."""
        want = set(pkgs)
        out = cu.meh(c.exec_, "pkgin", "-p", "list") or ""
        have = set()
        for line in out.splitlines():
            name = line.split(";", 1)[0]
            base = name.rsplit("-", 1)[0] if "-" in name else name
            have.add(base)
        return want & have

    def install(self, pkgs: Sequence[str]) -> None:
        have = self.installed(pkgs)
        missing = [p for p in pkgs if p not in have]
        if missing:
            with c.su():
                c.exec_("pkgin", "-y", "install", *missing)

    def setup_hostfile(self) -> None:
        """Append the local hostname to the loopback /etc/hosts line
        (smartos.clj:12-25) — SmartOS zones resolve themselves, not the
        whole cluster."""
        name = c.exec_("hostname").strip()
        hosts = c.exec_("cat", "/etc/hosts")
        out = []
        for line in hosts.splitlines():
            fields = line.split()
            if fields and fields[0] == "127.0.0.1" \
                    and name not in fields[1:]:
                line = f"{line} {name}"
            out.append(line)
        with c.su():
            cu.write_file("\n".join(out) + "\n", "/etc/hosts")

    def setup(self, test, node):
        log.info("Setting up smartos on %s", node)
        self.setup_hostfile()
        with c.su():
            cu.meh(c.exec_, "pkgin", "update")
        self.install(["curl", "wget", "gtar", "unzip"]
                     + self.packages)


smartos = SmartOS
