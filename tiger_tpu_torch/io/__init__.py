"""I/O layer: NetCDF (NETCDF4 through h5py, classic through scipy), lookup
remap, result writers.  Importing it needs neither h5py nor PyYAML."""

from tiger_tpu_torch.io.lookup import LookupTable
from tiger_tpu_torch.io.netcdf import (
    ClassicNetCDFWriter,
    NetCDFReader,
    NetCDFWriter,
    open_writer,
    read_netcdf,
    write_grid_forcing,
)
from tiger_tpu_torch.io.output import (
    write_dense_csv,
    write_dense_netcdf,
    write_dense_netcdf_packed,
    write_final_csv,
    write_final_netcdf,
)

__all__ = [
    "NetCDFReader",
    "NetCDFWriter",
    "ClassicNetCDFWriter",
    "open_writer",
    "read_netcdf",
    "write_grid_forcing",
    "LookupTable",
    "write_dense_csv",
    "write_dense_netcdf",
    "write_dense_netcdf_packed",
    "write_final_csv",
    "write_final_netcdf",
]
