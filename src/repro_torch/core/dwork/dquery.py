"""dquery — command-line dwork client (paper §2.2: "a command-line tool
(dquery) as an example client that can interact with the API from shell
scripts"), the port's copy of the JAX package's `repro.core.dwork.dquery`;
it speaks the same wire format, so either side's hub serves either's dquery.

    python -m repro_torch.core.dwork.dquery --host H --port P serve    # dhub
    python -m repro_torch.core.dwork.dquery --host H --port P create T \
        [-d DEP]...
    python -m repro_torch.core.dwork.dquery ... steal [-n N] [--worker W]
    python -m repro_torch.core.dwork.dquery ... complete T [--fail]
    python -m repro_torch.core.dwork.dquery ... transfer T -d NEWDEP...
    python -m repro_torch.core.dwork.dquery ... exit-worker --worker W
    python -m repro_torch.core.dwork.dquery ... stats
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.dwork.api import ExitResp, NotFound, TaskMsg
from repro_torch.core.dwork.client import Client, TCPServer, TCPTransport
from repro_torch.core.dwork.server import TaskServer


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dquery")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7781)
    ap.add_argument("--worker", default="dquery")
    ap.add_argument("--db", default="", help="persistence file (serve)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("serve")
    c = sub.add_parser("create")
    c.add_argument("task")
    c.add_argument("-d", "--dep", action="append", default=[])
    st = sub.add_parser("steal")
    st.add_argument("-n", type=int, default=1)
    co = sub.add_parser("complete")
    co.add_argument("task")
    co.add_argument("--fail", action="store_true")
    tr = sub.add_parser("transfer")
    tr.add_argument("task")
    tr.add_argument("-d", "--dep", action="append", default=[])
    sub.add_parser("exit-worker")
    sub.add_parser("stats")
    args = ap.parse_args(argv)

    if args.cmd == "serve":
        import pathlib
        srv = (TaskServer.load(args.db)
               if args.db and pathlib.Path(args.db).exists() else TaskServer())
        tcp = TCPServer((args.host, args.port), srv)
        print(f"dhub listening on {tcp.server_address}", flush=True)
        try:
            tcp.serve_forever()
        except KeyboardInterrupt:
            if args.db:
                srv.save(args.db)
                print(f"state saved to {args.db}")
        return 0

    cl = Client(TCPTransport(args.host, args.port), args.worker)
    if args.cmd == "create":
        cl.create(args.task, deps=args.dep)
        print("ok")
    elif args.cmd == "steal":
        r = cl.steal(n=args.n)
        if isinstance(r, TaskMsg):
            for name, meta in r.tasks:
                print(name if not meta else f"{name}\t{json.dumps(meta)}")
        elif isinstance(r, NotFound):
            print("NOTFOUND")
            return 3
        elif isinstance(r, ExitResp):
            print("EXIT")
            return 4
    elif args.cmd == "complete":
        cl.complete(args.task, ok=not args.fail)
        print("ok")
    elif args.cmd == "transfer":
        cl.transfer(args.task, args.dep)
        print("ok")
    elif args.cmd == "exit-worker":
        cl.exit()
        print("ok")
    elif args.cmd == "stats":
        print(json.dumps(cl.stats(), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
