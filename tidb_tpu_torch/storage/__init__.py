from tidb_tpu_torch.storage.table import Table, TableSchema  # noqa: F401
from tidb_tpu_torch.storage.catalog import Catalog  # noqa: F401
from tidb_tpu_torch.storage.scan import scan_table  # noqa: F401
from tidb_tpu_torch.storage.convert import add_table, catalog_from_numpy, table_state  # noqa: F401
