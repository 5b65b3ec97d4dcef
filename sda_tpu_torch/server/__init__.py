"""L3/L4: server core, ACL service wrapper, snapshot scheduler, stores."""

from __future__ import annotations

from .core import SdaServer, SdaServerService
from .memory import (
    MemoryAgentsStore,
    MemoryAggregationsStore,
    MemoryAuthTokensStore,
    MemoryClerkingJobsStore,
)
from .jsonfs import (
    JsonAgentsStore,
    JsonAggregationsStore,
    JsonAuthTokensStore,
    JsonClerkingJobsStore,
)
from .sqlite import (
    SqliteAgentsStore,
    SqliteAggregationsStore,
    SqliteAuthTokensStore,
    SqliteClerkingJobsStore,
    SqliteDb,
)
from .stores import (
    AgentsStore,
    AggregationsStore,
    AuthToken,
    AuthTokensStore,
    BaseStore,
    ClerkingJobsStore,
    auth_token,
)


def new_memory_server() -> SdaServerService:
    """Whole server in process memory — test/simulation fixture."""
    return SdaServerService(
        SdaServer(
            agents_store=MemoryAgentsStore(),
            auth_tokens_store=MemoryAuthTokensStore(),
            aggregation_store=MemoryAggregationsStore(),
            clerking_job_store=MemoryClerkingJobsStore(),
        )
    )


def new_sqlite_server(path) -> SdaServerService:
    """Single-file database server — the production-database tier
    (reference analog: the MongoDB backend, server-store-mongodb/)."""
    db = SqliteDb(path)
    return SdaServerService(
        SdaServer(
            agents_store=SqliteAgentsStore(db),
            auth_tokens_store=SqliteAuthTokensStore(db),
            aggregation_store=SqliteAggregationsStore(db),
            clerking_job_store=SqliteClerkingJobsStore(db),
        )
    )


def new_mongo_server(uri_or_db, dbname: str = "sda") -> SdaServerService:
    """MongoDB-backed server (reference: server-store-mongodb/). Accepts a
    connection URI (needs pymongo) or a pymongo-compatible Database object."""
    from . import mongo

    if isinstance(uri_or_db, str):
        if not mongo.available():
            raise RuntimeError(
                "pymongo is not installed; pass a pymongo-compatible Database "
                "or use new_sqlite_server for the in-image production tier"
            )
        import pymongo

        db = pymongo.MongoClient(uri_or_db)[dbname]
    else:
        db = uri_or_db
    return SdaServerService(
        SdaServer(
            agents_store=mongo.MongoAgentsStore(db),
            auth_tokens_store=mongo.MongoAuthTokensStore(db),
            aggregation_store=mongo.MongoAggregationsStore(db),
            clerking_job_store=mongo.MongoClerkingJobsStore(db),
        )
    )


def new_jsonfs_server(directory) -> SdaServerService:
    """Durable JSON-file-backed server (reference: new_jfs_server,
    server/src/lib.rs:34-45)."""
    from pathlib import Path

    root = Path(directory)
    return SdaServerService(
        SdaServer(
            agents_store=JsonAgentsStore(root / "agents"),
            auth_tokens_store=JsonAuthTokensStore(root / "auths"),
            aggregation_store=JsonAggregationsStore(root / "agg"),
            clerking_job_store=JsonClerkingJobsStore(root / "jobs"),
        )
    )
