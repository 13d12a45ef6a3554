"""A tour of harkdb_tpu_torch beyond the reference's two smoke queries (the
counterpart of examples/tour.py; those two queries are
examples/torch_demo.py).

Run:

    python examples/torch_tour.py [--cpu] [--ranks 4]

The single-device part runs on the CUDA device (the CPU with --cpu); the
mesh part then starts ``--ranks`` processes that join one
``torch.distributed`` group (gloo on the CPU, or several ranks sharing a
card; NCCL when every rank has a card of its own) and runs windows, a CTE,
a derived table and set operations over it; rank 0 prints. Under torchrun
only the mesh part runs, one rank per process:

    python -m torch.distributed.run --nproc-per-node 4 \\
        examples/torch_tour.py [--cpu]
"""

import argparse
import multiprocessing
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402


def tables():
    rng = np.random.default_rng(0)
    n = 10_000
    sales = pd.DataFrame({
        "region": rng.choice(["north", "south", "east", "west"], n),
        "product": rng.choice(["widget", "gadget", "doohickey"], n),
        "units": rng.integers(1, 50, n).astype(np.int32),
        "price": rng.uniform(5, 500, n).astype(np.float32),
    })
    regions = pd.DataFrame({
        "name": ["north", "south", "east", "west"],
        "manager": ["ada", "bob", "cyd", "dan"],
    })
    promos = pd.DataFrame({
        "prod": ["widget", "gizmo"], "discount": np.array([5, 9], np.int32),
    })
    return {"sales": sales, "regions": regions, "promos": promos}


SINGLE = [
    ("string predicates, LIKE, aggregates",
     "select region, product, sum(units) as total_units, "
     "avg(price) as avg_price "
     "from sales where product like '%get' and region != 'east' "
     "group by region, product order by total_units desc limit 5"),
    ("string-key join (dictionaries merge at plan time)",
     "select sales.region, regions.manager, sum(units) as u from sales "
     "join regions on sales.region = regions.name "
     "group by sales.region, regions.manager order by u desc"),
    ("window functions",
     "select region, units, "
     "row_number() over (partition by region order by units desc) as rn, "
     "sum(units) over (partition by region) as region_total "
     "from sales order by region, rn limit 8"),
    ("scalar + IN subqueries",
     "select region, count(*) as big_orders from sales "
     "where units > (select avg(units) from sales) "
     "and region in (select name from regions where manager != 'bob') "
     "group by region order by big_orders desc"),
    ("UNION ALL with trailing ORDER BY",
     "select region, units from sales where units >= 49 "
     "union all select region, units from sales where units = 1 "
     "order by units desc, region limit 6"),
    ("LEFT JOIN with real NULLs (IS NULL, NaN decode, aggregates skip)",
     "select product, count(*) as no_promo from sales "
     "left join promos on sales.product = promos.prod "
     "where promos.discount is null group by product order by product"),
    ("sliding-window frames (ROWS BETWEEN k PRECEDING ...)",
     "select region, units, sum(units) over (partition by region "
     "order by units rows between 2 preceding and current row) as last3 "
     "from sales order by region, units limit 6"),
    ("derived tables: aggregate of an aggregate",
     "select count(*) as hot_products, max(d.u) as top from "
     "(select product, region, sum(units) as u from sales "
     "group by product, region) d where d.u > 2000"),
    ("COALESCE defaults + CAST",
     "select product, coalesce(promos.discount, 0) as disc, "
     "cast(price as int) as whole from sales "
     "left join promos on sales.product = promos.prod "
     "order by price desc limit 5"),
    ("EXISTS as a semi-join",
     "select region, count(*) as n from sales where exists "
     "(select 1 from regions where regions.name = sales.region "
     "and regions.manager != 'bob') group by region order by region"),
    ("FULL OUTER JOIN",
     "select sales.product, promos.prod from sales "
     "full outer join promos on sales.product = promos.prod "
     "order by sales.product nulls last limit 5"),
    ("string functions + GROUP BY expressions",
     "select upper(substr(region, 1, 3)) as r3, count(*) as n "
     "from sales group by upper(substr(region, 1, 3)) order by r3"),
]

MESH = [
    ("partitioned window",
     "select region, units, rank() over "
     "(partition by region order by units desc) as rk "
     "from sales where units > 45 order by region, rk limit 6"),
    ("global running window (carry over ranks) with lag",
     "select units, price, sum(units) over (order by price) as running, "
     "lag(units, 1, -1) over (order by price) as prev "
     "from sales order by price limit 5"),
    ("window over grouped output",
     "select region, sum(units) as u, "
     "rank() over (order by sum(units) desc) as rk "
     "from sales group by region order by rk"),
    ("CTE + correlated aggregate",
     "with by_region as (select region, sum(units) as u from sales "
     "group by region) "
     "select region, u from by_region "
     "where u > (select avg(s2.units) from sales s2 "
     "where s2.region = by_region.region) order by u desc limit 4"),
    ("derived table",
     "select count(*) as hot_products, max(d.u) as top from "
     "(select product, region, sum(units) as u from sales "
     "group by product, region) d where d.u > 2000"),
    ("UNION (a sharded tail)",
     "select region from sales where units = 49 union "
     "select name from regions order by region"),
    ("INTERSECT",
     "select product from sales where units > 48 intersect "
     "select prod from promos"),
]


def single_device(device: str) -> None:
    from harkdb_tpu_torch import Context

    ctx = Context(device=device)
    for name, df in tables().items():
        ctx.create_table(name, df)
    for title, sql in SINGLE:
        print(f"\n— {title} —")
        print(ctx.sql_df(sql))


def mesh_part(mesh) -> None:
    """The MESH queries on every rank of ``mesh``; rank 0 prints."""
    from harkdb_tpu_torch import Context

    ctx = Context(mesh=mesh)
    for name, df in tables().items():
        ctx.create_table(name, df)
    for title, sql in MESH:
        df = ctx.sql_df(sql)             # every rank runs every query
        if mesh.rank == 0:
            print(f"\n— on a mesh of {mesh.size} ranks: {title} —")
            print(df, flush=True)


def _rank(rank: int, size: int, coordinator: str, cpu: bool) -> None:
    import torch
    import torch.distributed as dist

    from harkdb_tpu_torch.parallel.multihost import init_multihost

    torch.set_num_threads(1)
    cards = torch.cuda.device_count()
    device = "cpu" if cpu else f"cuda:{rank % max(cards, 1)}"
    mesh = init_multihost(coordinator, size, rank, device=device)
    try:
        mesh_part(mesh)
    finally:
        dist.destroy_process_group()


def spawn_mesh(ranks: int, cpu: bool) -> None:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, ranks, coordinator, cpu))
             for r in range(ranks)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise SystemExit(f"mesh ranks failed: exit codes {bad}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks of the mesh part (default 4)")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:               # under torchrun
        import torch.distributed as dist

        from harkdb_tpu_torch.parallel.multihost import init_from_env

        mesh = init_from_env(cpu=args.cpu)
        try:
            mesh_part(mesh)
        finally:
            dist.destroy_process_group()
        return
    single_device("cpu" if args.cpu else "cuda")
    spawn_mesh(args.ranks, args.cpu)


if __name__ == "__main__":
    main()
