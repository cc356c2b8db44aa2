"""MySQL Cluster (NDB) test suite
(mysql-cluster/src/jepsen/mysql_cluster.clj).

The reference suite's substance is its THREE-ROLE automation — every
node runs a management daemon (ndb_mgmd), the first four nodes run
storage daemons (ndbd), and every node runs a SQL frontend (mysqld),
each role claiming a distinct NDB node-id block (offsets 1/11/21,
mysql_cluster.clj:56-73) and all of them meeting through one shared
config.ini assembled from per-role snippets (:75-112). This module
replicates that algebra exactly and adds what the reference stopped
short of (its test map is `simple-test` = noop, :222-227): a
linearizable register workload over the family's shared from-scratch
MySQL wire codec (galera.MySqlConn), with CAS decided by the affected
-row count of a guarded UPDATE — NDB's engine-level row CAS.

Start ordering: the reference interleaves jepsen/synchronize barriers
so all mgmds exist before any ndbd boots (:191-203). Here each node
starts its roles in one pass — sound because ndbd/mysqld retry their
``--ndb-connectstring`` against the mgmd list (that list names every
node, :114-117), so role daemons converge as peers appear; the
db.Primary hook then polls ``ndb_mgm -e show`` for the fully-joined
topology before clients run.

Server modes: ``mini`` (default) LIVE in-repo MySQL-wire servers;
``deb`` emits the real mysql-cluster-gpl recipe (wget deb, dpkg
--force-confask/confnew idempotent install keyed on installed
version, :22-51) as command assertions.

The port's copy of `jepsen_tpu/dbs/mysql_cluster.py`, on the port's
`galera`. Its own choices: the mini servers listen from `MINI_BASE_PORT`
31200 (the reference's from 26100, so that both packages' servers can
run on one host at once; below Linux's ephemeral range, 32768-60999;
`deb` mode keeps MySQL's `PORT` 3306); `--device`, passed to the
register workload's competition race, whose device lane runs the WGL
chunk kernels there (default the card: a missing card raises before any
node is set up, `--device cpu` runs the plain PyTorch versions); the
store root `store/torch`.

    python -m jepsen_tpu_torch.dbs.mysql_cluster test --nodes m1 \
        --device cpu --time-limit 8
"""

from __future__ import annotations

import sys

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..util import resolve_device
from . import retryclient
from .galera import MySqlError, MiniGaleraDB, _GaleraBase

VERSION = "7.4.6"
PORT = 3306
MINI_BASE_PORT = 31200

MGMD_DIR = "/var/lib/mysql/cluster"
NDBD_DIR = "/var/lib/mysql/data"
MYSQLD_DIR = "/var/lib/mysql/mysql"
BIN = "/opt/mysql/server-5.6/bin"
USER = "mysql"

# node-id blocks per role (mysql_cluster.clj:56-58)
NDB_MGMD_OFFSET = 1
NDBD_OFFSET = 11
MYSQLD_OFFSET = 21
MAX_NDBD = 4  # storage group size (mysql_cluster.clj:98-101)


def mgmd_node_id(test: dict, node: str) -> int:
    return NDB_MGMD_OFFSET + test["nodes"].index(node)


def ndbd_node_id(test: dict, node: str) -> int:
    return NDBD_OFFSET + test["nodes"].index(node)


def mysqld_node_id(test: dict, node: str) -> int:
    return MYSQLD_OFFSET + test["nodes"].index(node)


def ndbd_nodes(test: dict) -> list:
    """First four nodes carry storage (mysql_cluster.clj:98-101)."""
    return sorted(test["nodes"][:MAX_NDBD])


def mgmd_conf(test: dict, node: str) -> str:
    return (f"[ndb_mgmd]\nNodeId={mgmd_node_id(test, node)}\n"
            f"hostname={node}\ndatadir={MGMD_DIR}\n")


def ndbd_conf(test: dict, node: str) -> str:
    return (f"[ndbd]\nNodeId={ndbd_node_id(test, node)}\n"
            f"hostname={node}\ndatadir={NDBD_DIR}\n")


def mysqld_conf(test: dict, node: str) -> str:
    return (f"[mysqld]\nNodeId={mysqld_node_id(test, node)}\n"
            f"hostname={node}\n")


def nodes_conf(test: dict) -> str:
    """All roles on all nodes, one section per daemon
    (mysql_cluster.clj:103-112): mgmd+mysqld everywhere, ndbd on the
    storage group."""
    parts = ([mgmd_conf(test, n) for n in test["nodes"]]
             + [ndbd_conf(test, n) for n in ndbd_nodes(test)]
             + [mysqld_conf(test, n) for n in test["nodes"]])
    return "\n".join(parts)


def ndb_connect_string(test: dict) -> str:
    return ",".join(test["nodes"])


MY_CNF_TEMPLATE = """[mysqld]
ndbcluster
server-id=%NODE_ID%
datadir=%DATA_DIR%
ndb-connectstring=%NDB_CONNECT_STRING%
user=mysql
[mysql_cluster]
ndb-connectstring=%NDB_CONNECT_STRING%
"""

CONFIG_INI_HEADER = """[ndbd default]
NoOfReplicas=2
DataMemory=256M
IndexMemory=64M
"""


class MySQLClusterDB(jdb.DB, jdb.Process, jdb.Primary, jdb.LogFiles):
    """NDB three-role lifecycle (mysql_cluster.clj:187-220)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def deb_url(self) -> str:
        return ("https://dev.mysql.com/get/Downloads/MySQL-Cluster-7.4"
                f"/mysql-cluster-gpl-{self.version}-debian7-x86_64.deb")

    def install(self, test, node):
        with control.su():
            control.exec_("apt-get", "install", "-y", "libaio1")
            with control.cd("/tmp"):
                control.exec_("wget", "-nc", self.deb_url())
                deb = self.deb_url().rsplit("/", 1)[1]
                # idempotent keyed on installed version (:32-39)
                control.exec_(
                    "bash", "-c",
                    f"dpkg-query -W -f '${{Version}}' mysql-cluster-gpl"
                    f" 2>/dev/null | grep -q {self.version} || "
                    f"dpkg -i --force-confask --force-confnew {deb}")
            nodeutil.meh(control.exec_, "adduser",
                         "--disabled-password", "--gecos", "", USER)

    def configure(self, test, node):
        with control.su():
            nodeutil.write_file(
                MY_CNF_TEMPLATE
                .replace("%NODE_ID%", str(mysqld_node_id(test, node)))
                .replace("%DATA_DIR%", MYSQLD_DIR)
                .replace("%NDB_CONNECT_STRING%",
                         ndb_connect_string(test)),
                "/etc/my.cnf")
            control.exec_("mkdir", "-p", MGMD_DIR)
            nodeutil.write_file(CONFIG_INI_HEADER + nodes_conf(test),
                                "/etc/my.config.ini")

    def start_data_roles(self, test, node):
        """ndbd (storage group) + mysqld — the roles kill() faults;
        ndb_mgmd has its own start in setup (it survives kills so
        restarts can rejoin)."""
        with control.su():
            if node in ndbd_nodes(test):
                control.exec_("mkdir", "-p", NDBD_DIR)
                control.exec_(f"{BIN}/ndbd",
                              f"--ndb-nodeid={ndbd_node_id(test, node)}")
            control.exec_("mkdir", "-p", MYSQLD_DIR)
            control.exec_("chown", "-R", f"{USER}:{USER}", MYSQLD_DIR)
        with control.sudo_user(USER):
            # mysqld_safe is a supervisor that never exits:
            # background it (the ignite.sh `&` discipline)
            control.exec_(f"{BIN}/mysqld_safe",
                          "--defaults-file=/etc/my.cnf",
                          control.lit(">>/var/log/mysqld_safe.log "
                                      "2>&1 &"))

    def setup(self, test, node):
        self.install(test, node)
        self.configure(test, node)
        with control.su():
            control.exec_(f"{BIN}/ndb_mgmd",
                          f"--ndb-nodeid={mgmd_node_id(test, node)}",
                          "-f", "/etc/my.config.ini")
        self.start_data_roles(test, node)

    def setup_primary(self, test, node):
        """db.Primary hook — runs after every node's setup: await the
        fully-joined topology (the reference's synchronize+60 s sleep,
        :195-203, replaced by an actual readiness poll)."""
        # ready = ndb_mgm reports a topology ("id=" lines) with no
        # "not connected" slots; a failing ndb_mgm (no output) must
        # NOT count as ready
        control.exec_(
            "bash", "-c",
            f"for i in $(seq 60); do "
            f"out=$({BIN}/ndb_mgm -e show "
            f"--ndb-connectstring={ndb_connect_string(test)} "
            f"2>/dev/null); "
            f"if echo \"$out\" | grep -q 'id=' && "
            f"! echo \"$out\" | grep -q 'not connected'; "
            f"then exit 0; fi; sleep 2; done; exit 1")

    def teardown(self, test, node):
        with control.su():  # the role daemons run as root/mysql
            for proc in ("mysqld", "ndbd", "ndb_mgmd"):
                nodeutil.meh(nodeutil.grepkill, proc)
            control.exec_("rm", "-rf",
                          control.lit(f"{MGMD_DIR}/*"),
                          control.lit(f"{NDBD_DIR}/*"),
                          control.lit(f"{MYSQLD_DIR}/*"))

    def start(self, test, node):
        # heal path: only the killed roles — the surviving mgmd
        # would refuse a duplicate node-id relaunch
        self.start_data_roles(test, node)
        return "started"

    def kill(self, test, node):
        """Kill the SQL frontend + storage daemon; mgmd survives so
        restarts can rejoin (stop-*! trio, :169-185)."""
        with control.su():  # the role daemons run as root/mysql
            nodeutil.meh(nodeutil.grepkill, "mysqld")
            nodeutil.meh(nodeutil.grepkill, "ndbd")
        return "killed"

    def log_files(self, test, node):
        return [f"{MGMD_DIR}/ndb_1_cluster.log",
                f"{MYSQLD_DIR}/mysqld.err"]


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "ndb_ports")


class MiniNdbDB(MiniGaleraDB):
    def port(self, test, node):
        return mini_node_port(test, node)


class NdbRegisterClient(_GaleraBase):
    """Independent-keyed register over ENGINE=NDBCLUSTER tables; CAS
    = guarded UPDATE decided on the affected-row count (NDB row CAS).
    Deb mode creates the table with the ndbcluster engine; the mini
    dialect bridge accepts and ignores the clause."""

    def setup(self, test):
        conn = self._conn(test)
        try:
            conn.query("CREATE TABLE IF NOT EXISTS registers "
                       "(id INTEGER PRIMARY KEY, value BIGINT) "
                       "ENGINE=NDBCLUSTER")
        except MySqlError:
            pass

    def invoke(self, test, op):
        f = op["f"]
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, v = kv
        try:
            conn = self._conn(test)
            if f == "read":
                rows, _ = conn.query(
                    f"SELECT value FROM registers WHERE id={int(k)}")
                val = int(rows[0][0]) if rows else None
                return {**op, "type": "ok", "value": tuple_(k, val)}
            if f == "write":
                _, n = conn.query(
                    f"REPLACE INTO registers VALUES ({int(k)}, {int(v)})")
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                _, n = conn.query(
                    f"UPDATE registers SET value={int(new)} "
                    f"WHERE id={int(k)} AND value={int(old)}")
                return {**op, "type": "ok" if n else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, MySqlError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


def _w_register(options):
    from ..workloads import linearizable_register
    w = linearizable_register.workload(
        {"nodes": options["nodes"],
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": options.get("device")})
    return {**w, "client": NdbRegisterClient()}


WORKLOADS = {"register": _w_register}


def ndb_test(options: dict) -> dict:
    """The register check's device lane runs on `options["device"]`
    (default the card), resolved here, so that a missing card raises
    before any node is set up."""
    options = {**options, "device": resolve_device(options.get("device"))}
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    which = options.get("workload") or "register"
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None

    client = w["client"]
    if mode == "mini":
        db: jdb.DB = MiniNdbDB()
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, node))
        client.pin_primary = True
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "ndb-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "deb":
        db = MySQLClusterDB(options.get("version") or VERSION)
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    interval = options.get("nemesis_interval") or 3.0
    time_limit = options.get("time_limit") or 10
    nemesis = jnemesis.node_start_stopper(
        lambda ns: [ns[0]],
        lambda test, node: db.kill(test, node),
        lambda test, node: db.start(test, node))
    workload_gen = retryclient.standard_generator(
        w, nemesis, interval, time_limit)
    return {
        "name": options.get("name") or f"mysql-cluster-{which}-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": nemesis,
        "checker": jchecker.compose({
            which: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **extra,
    }


NDB_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo MySQL-wire servers) or deb "
                 "(real mysql-cluster-gpl on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default="register"),
    cli.Opt("sandbox", metavar="DIR", default="ndb-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": ndb_test,
                           "opt_spec": NDB_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
