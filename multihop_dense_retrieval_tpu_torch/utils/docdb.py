"""Sqlite document store (utils/utils.py:87-124 parity).

Used by data-prep pipelines that read full Wikipedia dumps; the serving path
uses the in-memory Corpus/id2doc table instead.  A copy of the JAX
package's ``utils/docdb.py``: the two read each other's files.
"""

from __future__ import annotations

import sqlite3
import unicodedata
from typing import List, Optional


class DocDB:
    def __init__(self, db_path: str):
        self.path = db_path
        self.connection = sqlite3.connect(db_path, check_same_thread=False)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self):
        self.connection.close()

    @staticmethod
    def create(db_path: str):
        conn = sqlite3.connect(db_path)
        conn.execute("CREATE TABLE IF NOT EXISTS documents "
                     "(id PRIMARY KEY, text, sentence_spans);")
        conn.commit()
        conn.close()
        return DocDB(db_path)

    def insert(self, doc_id: str, text: str, sentence_spans: str = ""):
        self.insert_many([(doc_id, text, sentence_spans)])

    def insert_many(self, rows):
        """Bulk insert of (doc_id, text, sentence_spans) tuples in ONE
        transaction — per-row commits fsync once per document, which at
        full-Wikipedia scale (~5M rows) is hours of pure commit overhead."""
        self.connection.executemany(
            "INSERT OR REPLACE INTO documents VALUES (?,?,?)",
            ((unicodedata.normalize("NFD", i), t, s) for i, t, s in rows))
        self.connection.commit()

    def get_doc_ids(self) -> List[str]:
        cur = self.connection.execute("SELECT id FROM documents")
        return [r[0] for r in cur.fetchall()]

    def get_doc_text(self, doc_id: str) -> Optional[str]:
        cur = self.connection.execute(
            "SELECT text FROM documents WHERE id = ?",
            (unicodedata.normalize("NFD", doc_id),))
        row = cur.fetchone()
        return row[0] if row else None

    def get_sentence_spans(self, doc_id: str) -> Optional[str]:
        cur = self.connection.execute(
            "SELECT sentence_spans FROM documents WHERE id = ?",
            (unicodedata.normalize("NFD", doc_id),))
        row = cur.fetchone()
        return row[0] if row else None
