"""Key→SMILES sidecar stores."""

from rad_tpu_torch.store.smiles_store import (
    InMemorySmilesStore,
    SmilesStore,
    SQLiteSmilesStore,
    create_smiles_db,
)

__all__ = [
    "SmilesStore",
    "SQLiteSmilesStore",
    "InMemorySmilesStore",
    "create_smiles_db",
]
