"""The TPC-W deployment as the benchmark sees it, independent of the
program: the nine tables (columns, primary key, capacity), the 13 query
templates with their slot capacities, and the update slots of a beat.

Capacities follow the storage slack rule the configuration states
(``headroom``: growth room as a share of the initial rows, at least a
fixed floor), the rule of ``repro_torch.workloads.tpcw.make_catalog``
frozen here.  The reference itself keeps every table unbounded; the
capacities size the group-by's groups and the kernels' least work
(``bench/roofline``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

INT_MAX = 2147483647


@dataclasses.dataclass(frozen=True)
class Table:
    name: str
    columns: Tuple[str, ...]
    capacity: int
    pk: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Template:
    """A parameterised query: ``preds`` are (table, column) inclusive
    ranges bound by parameter index; ``joins`` are (spine fk column, PK
    table) inner joins; the result is row ids of the spine, sorted by
    ``sort`` (ties by row id) or in row order, cut at ``limit``, or the
    group-by's top ``top_k`` groups by the sum of ``agg`` (ties toward
    the lower group)."""
    name: str
    spine: str
    preds: Tuple[Tuple[str, str], ...]
    joins: Tuple[Tuple[str, str], ...] = ()
    sort: Optional[str] = None
    desc: bool = False
    limit: int = 16
    group: Optional[str] = None          # group column on the spine
    agg: Optional[str] = None            # summed column on the spine
    top_k: int = 0
    n_groups: int = 0                    # group codes in [0, n_groups)
    cap: int = 0                         # queries of the template a beat


def tables(scale_items: int, scale_customers: int,
           headroom: float) -> Dict[str, Table]:
    h = headroom
    items_cap = scale_items + 2048
    cust_cap = scale_customers + max(2048, int(scale_customers * h))
    orders0 = int(scale_customers * 0.9)
    orders_cap = orders0 + max(4096, int(orders0 * h))
    ol_cap = orders0 * 3 + max(8192, int(orders0 * 3 * h))
    out = [
        Table("country", ("co_id", "co_name"), 128, "co_id"),
        Table("address", ("addr_id", "addr_co_id", "addr_street"),
              cust_cap + 8192, "addr_id"),
        Table("customer", ("c_id", "c_uname", "c_passwd", "c_addr_id",
                           "c_discount", "c_since", "c_expiration"),
              cust_cap, "c_id"),
        Table("author", ("a_id", "a_fname", "a_lname"),
              max(scale_items // 4 + 1024, 2048), "a_id"),
        Table("item", ("i_id", "i_a_id", "i_subject", "i_title",
                       "i_pub_date", "i_cost", "i_srp", "i_stock",
                       "i_related1"), items_cap, "i_id"),
        Table("orders", ("o_id", "o_c_id", "o_date", "o_total", "o_status"),
              orders_cap, "o_id"),
        Table("order_line", ("ol_o_id", "ol_i_id", "ol_qty", "ol_discount"),
              ol_cap),
        Table("cc_xacts", ("cx_o_id", "cx_type", "cx_amount"), orders_cap,
              "cx_o_id"),
        Table("shopping_cart_line", ("scl_id", "scl_sc_id", "scl_i_id",
                                     "scl_qty"), max(8192, cust_cap),
              "scl_id"),
    ]
    return {t.name: t for t in out}


def templates(items_cap: int) -> Dict[str, Template]:
    """The templates and their slot capacities; the group-by's groups are
    the item table's rows (``items_cap``)."""
    T = [
        Template("get_customer", "customer", (("customer", "c_uname"),),
                 limit=1, cap=64),
        Template("get_password", "customer", (("customer", "c_id"),),
                 limit=1, cap=16),
        Template("get_book", "item", (("item", "i_id"),),
                 (("i_a_id", "author"),), limit=1, cap=64),
        Template("get_related", "item", (("item", "i_id"),), limit=1,
                 cap=32),
        Template("admin_item", "item", (("item", "i_id"),), limit=1, cap=8),
        Template("search_subject", "item", (("item", "i_subject"),),
                 sort="i_title", limit=50, cap=32),
        Template("search_title", "item", (("item", "i_title"),),
                 sort="i_title", limit=50, cap=32),
        Template("search_author", "item", (("author", "a_lname"),),
                 (("i_a_id", "author"),), sort="i_title", limit=50, cap=32),
        Template("new_products", "item", (("item", "i_subject"),),
                 sort="i_pub_date", desc=True, limit=50, cap=32),
        Template("best_sellers", "order_line",
                 (("orders", "o_id"), ("item", "i_subject")),
                 (("ol_o_id", "orders"), ("ol_i_id", "item")),
                 group="ol_i_id", agg="ol_qty", top_k=50,
                 n_groups=items_cap, cap=64),
        Template("order_lines", "order_line", (("order_line", "ol_o_id"),),
                 (("ol_i_id", "item"),), limit=32, cap=8),
        Template("order_display", "orders", (("orders", "o_c_id"),),
                 sort="o_date", desc=True, limit=1, cap=8),
        Template("get_cart", "shopping_cart_line",
                 (("shopping_cart_line", "scl_sc_id"),),
                 (("scl_i_id", "item"),), limit=32, cap=16),
    ]
    return {t.name: t for t in T}


def deployment(cfg: dict):
    """(tables, templates) of a configuration file's deployment."""
    tbl = tables(cfg["scale_items"], cfg["scale_customers"], cfg["headroom"])
    return tbl, templates(tbl["item"].capacity)
