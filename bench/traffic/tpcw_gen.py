"""Frozen copy of the TPC-W data and traffic generator of
``repro_torch/workloads/tpcw.py`` (``generate_data``, ``MIXES``,
``WI_TIMEOUT``, ``Interaction``, ``WorkloadGenerator``), so that the
benchmark's inputs stay fixed while the program changes.

Column encoding as in the program: every value an int32 (strings
dictionary-encoded, money in cents, dates as integer days).  Seeded only
by the ``numpy.random.Generator`` it is handed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

INT_MAX = 2147483647
N_SUBJECTS = 24
N_TITLE_TOKENS = 1000
N_LNAMES = 500


def generate_data(rng: np.random.Generator, scale_items: int = 10000,
                  scale_customers: int = 28800) -> Dict:
    n_auth = scale_items // 4
    orders0 = int(scale_customers * 0.9)
    data = {}
    data["country"] = {"co_id": np.arange(92),
                       "co_name": np.arange(92)}
    data["address"] = {
        "addr_id": np.arange(scale_customers),
        "addr_co_id": rng.integers(0, 92, scale_customers),
        "addr_street": rng.integers(0, 10000, scale_customers)}
    data["customer"] = {
        "c_id": np.arange(scale_customers),
        "c_uname": np.arange(scale_customers),      # unique -> code == id
        "c_passwd": rng.integers(0, 1 << 30, scale_customers),
        "c_addr_id": np.arange(scale_customers),
        "c_discount": rng.integers(0, 51, scale_customers),
        "c_since": rng.integers(10000, 12000, scale_customers),
        "c_expiration": rng.integers(12000, 14000, scale_customers)}
    data["author"] = {
        "a_id": np.arange(n_auth),
        "a_fname": rng.integers(0, N_LNAMES, n_auth),
        "a_lname": rng.integers(0, N_LNAMES, n_auth)}
    data["item"] = {
        "i_id": np.arange(scale_items),
        "i_a_id": rng.integers(0, n_auth, scale_items),
        "i_subject": rng.integers(0, N_SUBJECTS, scale_items),
        "i_title": rng.integers(0, N_TITLE_TOKENS, scale_items),
        "i_pub_date": rng.integers(8000, 12000, scale_items),
        "i_cost": rng.integers(100, 10000, scale_items),
        "i_srp": rng.integers(100, 12000, scale_items),
        "i_stock": rng.integers(10, 30, scale_items),
        "i_related1": rng.integers(0, scale_items, scale_items)}
    o_date = np.sort(rng.integers(11000, 12000, orders0))
    data["orders"] = {
        "o_id": np.arange(orders0),
        "o_c_id": rng.integers(0, scale_customers, orders0),
        "o_date": o_date,
        "o_total": rng.integers(100, 50000, orders0),
        "o_status": rng.integers(0, 4, orders0)}
    n_ol = orders0 * 3
    data["order_line"] = {
        "ol_o_id": np.repeat(np.arange(orders0), 3),
        "ol_i_id": rng.integers(0, scale_items, n_ol),
        "ol_qty": rng.integers(1, 10, n_ol),
        "ol_discount": rng.integers(0, 30, n_ol)}
    data["cc_xacts"] = {
        "cx_o_id": np.arange(orders0),
        "cx_type": rng.integers(0, 5, orders0),
        "cx_amount": data["orders"]["o_total"]}
    n_carts = 2048
    data["shopping_cart_line"] = {
        "scl_id": np.arange(n_carts * 2),
        "scl_sc_id": np.repeat(np.arange(n_carts), 2),
        "scl_i_id": rng.integers(0, scale_items, n_carts * 2),
        "scl_qty": rng.integers(1, 5, n_carts * 2)}
    return data


MIXES = {
    "browsing": {
        "home": 29.00, "new_products": 11.00, "best_sellers": 11.00,
        "product_detail": 21.00, "search_request": 12.00,
        "search_results": 11.00, "shopping_cart": 2.00,
        "customer_registration": 0.82, "buy_request": 0.75,
        "buy_confirm": 0.69, "order_inquiry": 0.30, "order_display": 0.25,
        "admin_request": 0.10, "admin_confirm": 0.09},
    "shopping": {
        "home": 16.00, "new_products": 5.00, "best_sellers": 5.00,
        "product_detail": 17.00, "search_request": 20.00,
        "search_results": 17.00, "shopping_cart": 11.60,
        "customer_registration": 3.00, "buy_request": 2.60,
        "buy_confirm": 1.20, "order_inquiry": 0.75, "order_display": 0.66,
        "admin_request": 0.10, "admin_confirm": 0.09},
    "ordering": {
        "home": 9.12, "new_products": 0.46, "best_sellers": 0.46,
        "product_detail": 12.35, "search_request": 14.53,
        "search_results": 13.08, "shopping_cart": 13.53,
        "customer_registration": 12.86, "buy_request": 12.73,
        "buy_confirm": 10.18, "order_inquiry": 0.25, "order_display": 0.22,
        "admin_request": 0.12, "admin_confirm": 0.11},
}

# web-interaction SLA timeouts (seconds) from the TPC-W spec
WI_TIMEOUT = {
    "home": 3, "new_products": 5, "best_sellers": 5, "product_detail": 3,
    "search_request": 3, "search_results": 10, "shopping_cart": 3,
    "customer_registration": 3, "buy_request": 3, "buy_confirm": 5,
    "order_inquiry": 3, "order_display": 3, "admin_request": 3,
    "admin_confirm": 5,
}


@dataclasses.dataclass
class Interaction:
    kind: str
    queries: List[Tuple[str, Dict[int, Tuple[int, int]]]]
    updates: List[Tuple[str, str, Dict]]


class WorkloadGenerator:
    """Generates web interactions -> template invocations + updates."""

    def __init__(self, rng: np.random.Generator, scale_items: int = 10000,
                 scale_customers: int = 28800):
        self.rng = rng
        self.n_items = scale_items
        self.n_cust = scale_customers
        self._next_order = int(scale_customers * 0.9)
        self._next_cart_line = 4096
        self._next_cust = scale_customers
        self._next_cart = 2048

    def _eq(self, v: int):
        return (int(v), int(v))

    def interaction(self, kind: str) -> Interaction:
        rng = self.rng
        c = int(rng.integers(0, self.n_cust))
        i = int(rng.integers(0, self.n_items))
        subj = int(rng.integers(0, N_SUBJECTS))
        q, u = [], []
        if kind == "home":
            q = [("get_customer", {0: self._eq(c)}),
                 ("get_related", {0: self._eq(i)})]
        elif kind == "new_products":
            q = [("new_products", {0: self._eq(subj)})]
        elif kind == "best_sellers":
            lo = max(0, self._next_order - 3333)
            q = [("best_sellers", {0: (lo, INT_MAX), 1: self._eq(subj)})]
        elif kind == "product_detail":
            q = [("get_book", {0: self._eq(i)})]
        elif kind == "search_request":
            q = [("get_related", {0: self._eq(i)})]
        elif kind == "search_results":
            mode = rng.integers(0, 3)
            if mode == 0:
                q = [("search_subject", {0: self._eq(subj)})]
            elif mode == 1:
                q = [("search_title",
                      {0: self._eq(int(rng.integers(0, N_TITLE_TOKENS)))})]
            else:
                q = [("search_author",
                      {0: self._eq(int(rng.integers(0, N_LNAMES)))})]
        elif kind == "shopping_cart":
            cart = int(rng.integers(0, self._next_cart))
            q = [("get_cart", {0: self._eq(cart)})]
            sid = self._next_cart_line
            self._next_cart_line += 1
            u = [("shopping_cart_line", "insert",
                  {"scl_id": sid, "scl_sc_id": cart, "scl_i_id": i,
                   "scl_qty": int(rng.integers(1, 4))})]
        elif kind == "customer_registration":
            new_c = self._next_cust
            self._next_cust += 1
            self._next_cart += 1
            q = [("get_customer", {0: self._eq(c)})]
            u = [("address", "insert",
                  {"addr_id": new_c, "addr_co_id": int(rng.integers(0, 92)),
                   "addr_street": int(rng.integers(0, 10000))}),
                 ("customer", "insert",
                  {"c_id": new_c, "c_uname": new_c,
                   "c_passwd": int(rng.integers(0, 1 << 30)),
                   "c_addr_id": new_c,
                   "c_discount": int(rng.integers(0, 51)),
                   "c_since": 12000, "c_expiration": 14000})]
        elif kind == "buy_request":
            cart = int(rng.integers(0, self._next_cart))
            q = [("get_customer", {0: self._eq(c)}),
                 ("get_cart", {0: self._eq(cart)})]
            u = [("customer", "update",
                  {"key": c, "col": "c_expiration", "val": 14600})]
        elif kind == "buy_confirm":
            o = self._next_order
            self._next_order += 1
            total = int(rng.integers(100, 50000))
            u = [("orders", "insert",
                  {"o_id": o, "o_c_id": c, "o_date": 12000,
                   "o_total": total, "o_status": 0}),
                 ("cc_xacts", "insert",
                  {"cx_o_id": o, "cx_type": int(rng.integers(0, 5)),
                   "cx_amount": total})]
            for _ in range(int(rng.integers(1, 4))):
                u.append(("order_line", "insert",
                          {"ol_o_id": o,
                           "ol_i_id": int(rng.integers(0, self.n_items)),
                           "ol_qty": int(rng.integers(1, 10)),
                           "ol_discount": int(rng.integers(0, 30))}))
            q = [("get_customer", {0: self._eq(c)})]
        elif kind == "order_inquiry":
            q = [("get_password", {0: self._eq(c)})]
        elif kind == "order_display":
            q = [("order_display", {0: self._eq(c)}),
                 ("order_lines",
                  {0: self._eq(int(rng.integers(0, self._next_order)))}),
                 ("get_customer", {0: self._eq(c)})]
        elif kind == "admin_request":
            q = [("admin_item", {0: self._eq(i)})]
        elif kind == "admin_confirm":
            q = [("admin_item", {0: self._eq(i)})]
            u = [("item", "update",
                  {"key": i, "col": "i_cost",
                   "val": int(rng.integers(100, 10000))})]
        else:
            raise ValueError(kind)
        return Interaction(kind, q, u)

    def sample_mix(self, mix: str, n: int) -> List[Interaction]:
        kinds = list(MIXES[mix])
        probs = np.array([MIXES[mix][k] for k in kinds])
        probs = probs / probs.sum()
        picks = self.rng.choice(len(kinds), size=n, p=probs)
        return [self.interaction(kinds[p]) for p in picks]
