"""Minimal NetCDF reader/writer: NETCDF4 through h5py, classic through scipy.

A copy of ``tiger_tpu/io/netcdf.py``.  NETCDF4-format files are HDF5 files,
so this module reads and writes them directly with h5py: datasets are
variables, dimensions are HDF5 dimension scales, attributes pass through,
and the files carry the _Netcdf4* bookkeeping attributes that netCDF4/xarray
readers expect.  Classic NetCDF (CDF-1/2) is read and written through scipy
(``ClassicNetCDFWriter``), which needs no h5py: ``open_writer`` writes the
outputs in classic NetCDF where h5py is not installed.

Two changes from the JAX package: h5py is imported where a NETCDF4 file is
opened, so importing this module needs no h5py; and ``NetCDFWriter.def_var``
takes torch tensors on any device, pulling a CUDA tensor slab by slab.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

_DIM_ANON = "This is a netCDF dimension but not a netCDF variable."

#: Bytes of one slab of rows that ``NetCDFWriter.def_var`` pulls from a
#: tensor at a time.
SLAB_BYTES = 128 * 2**20


def _to_host(data) -> np.ndarray:
    """A numpy array of ``data``: a tensor is copied to the host."""
    if torch.is_tensor(data):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _np_dtype(data) -> np.dtype:
    """The numpy dtype of an array or a tensor."""
    if torch.is_tensor(data):
        return torch.empty((), dtype=data.dtype).numpy().dtype
    return np.asarray(data).dtype


class NetCDFReader:
    """Windowed reader for one gridded variable of a NetCDF file.

    Equivalent of the reference NetCDFLoader (forcing_loader.cpp:76-218):
    assumes dims ordered (time, lat, lon) for 3-D variables.  NETCDF4 (HDF5)
    files read through h5py; classic NetCDF3 (CDF-1/2 magic) through a
    memory-mapped scipy reader — both give windowed time reads without
    loading the whole record.
    """

    def __init__(self, path: str, var_name: str):
        with open(path, "rb") as fh:
            magic = fh.read(4)
        self._classic = magic[:3] == b"CDF"
        if self._classic:
            from scipy.io import netcdf_file

            self._f = netcdf_file(path, "r", mmap=True)
        else:
            import h5py

            self._f = h5py.File(path, "r")
        # Close on EVERY init failure: forcing folder discovery probes many
        # candidate files and catches these errors, so a leaked handle per
        # probe accumulates (and HDF5 read locks can block later writers).
        self._var = None
        try:
            if self._classic:
                if var_name not in self._f.variables:
                    raise KeyError(f"Variable {var_name!r} not found in {path}")
                self._var = self._f.variables[var_name]
            else:
                if var_name not in self._f:
                    raise KeyError(f"Variable {var_name!r} not found in {path}")
                self._var = self._f[var_name]
            shape = self._var.shape
            if len(shape) != 3:
                raise ValueError(
                    f"Expected 3D variable (time, lat, lon), got {len(shape)}D"
                )
        except Exception:
            self.close()
            raise
        self.time_size, self.lat_size, self.lon_size = shape
        self.path, self.var_name = path, var_name

    def load_time_chunk(self, start: int, count: int) -> np.ndarray:
        """Read ``count`` time slices from ``start`` -> float32 [count, lat, lon].

        Bounds semantics match loadTimeChunk (forcing_loader.cpp:164-196).
        Applies CF packing (``scale_factor``/``add_offset``) when present —
        distributed ERA5 files are typically int16-packed.
        """
        if count <= 0:
            raise ValueError("Size of time chunk must be greater than zero")
        if start < 0 or start >= self.time_size:
            raise IndexError("Start time index out of range")
        if start + count > self.time_size:
            raise IndexError("Requested time steps exceed available data")
        raw = np.array(self._var[start : start + count])
        attrs = self.attrs()

        def scalar(key):
            v = attrs.get(key)
            if v is None:
                return None
            v = np.asarray(v).reshape(-1)[0]
            return float(v)

        scale = scalar("scale_factor")
        offset = scalar("add_offset")
        fill = attrs.get("_FillValue", attrs.get("missing_value"))
        if scale is not None or offset is not None:
            out = raw.astype(np.float64)
            if fill is not None:
                out[raw == np.asarray(fill).reshape(-1)[0]] = np.nan
            out = out * (scale if scale is not None else 1.0) + (
                offset if offset is not None else 0.0
            )
            return out.astype(np.float32)
        out = raw.astype(np.float32)
        if fill is not None:
            # Unpacked variables carry fill values too (ERA5-Land ocean
            # cells): map them to NaN so downstream validation can tell a
            # missing cell from a real value instead of integrating -9999.
            out[raw == np.asarray(fill).reshape(-1)[0]] = np.nan
        return out

    #: HDF5 dimension-scale bookkeeping attrs — not CF metadata.
    _HDF5_INTERNAL = ("DIMENSION_LIST", "REFERENCE_LIST", "NAME", "CLASS")

    def attrs(self) -> dict:
        if self._classic:
            return dict(getattr(self._var, "_attributes", {}))
        return {
            k: v
            for k, v in self._var.attrs.items()
            if not k.startswith("_Netcdf") and k not in self._HDF5_INTERNAL
        }

    def time_info(self):
        """(time coordinate values, units string) or (None, None).

        Used by forcing folder discovery to infer each variable's time step
        (the reference hard-codes dt per file, main.cpp:508-515).
        """
        if self._classic:
            tv = self._f.variables.get("time")
            if tv is None:
                return None, None
            units = getattr(tv, "units", None) or tv._attributes.get("units")
            vals = np.array(tv[:], np.float64)
        else:
            if "time" not in self._f:
                return None, None
            ds = self._f["time"]
            if ds.attrs.get("NAME", b"").startswith(_DIM_ANON.encode()):
                return None, None  # anonymous dimension, no coordinate values
            vals = np.asarray(ds[:], np.float64)
            units = ds.attrs.get("units")
        if isinstance(units, bytes):
            units = units.decode()
        return vals, units

    def close(self):
        if self._classic:
            # Every chunk we hand out is np.array-copied, so the mmap can go;
            # scipy still warns because variable objects reference it — drop
            # them and silence that specific warning.
            import warnings

            self._var = None
            self._f.variables = {}
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                self._f.close()
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _stream_rows(data, out_dtype: np.dtype, store) -> None:
    """Hand ``data`` to ``store(i0, rows)`` in slabs of rows as host arrays.

    One-slab-ahead prefetch: the device->host pull of slab i+1 runs on a
    worker thread while slab i is stored, so a dense tensor on the card is
    never duplicated whole on the host.
    """
    row_bytes = max(int(np.prod(data.shape[1:], dtype=np.int64)) * out_dtype.itemsize, 1)
    slab = max(SLAB_BYTES // row_bytes, 1)
    n_rows = data.shape[0]
    with ThreadPoolExecutor(max_workers=1) as ex:
        nxt = ex.submit(_to_host, data[0:slab])
        for i0 in range(0, n_rows, slab):
            cur = nxt.result()
            if i0 + slab < n_rows:
                nxt = ex.submit(_to_host, data[i0 + slab : i0 + 2 * slab])
            store(i0, cur)


class NetCDFWriter:
    """NETCDF4 writer (h5py): define dims, coordinate vars, data vars,
    attributes.  The JAX package's writer: its files hold the same
    datasets, dimension scales and attributes."""

    def __init__(self, path: str):
        import h5py

        self._f = h5py.File(path, "w")
        self._f.attrs["_NCProperties"] = np.bytes_(b"version=2,tiger_tpu=" + b"0.1")
        self._dims: dict = {}
        self._dimid = 0

    def def_dim(self, name: str, size: int, coord: Optional[np.ndarray] = None, dtype=None):
        """Define a dimension, optionally with coordinate values."""
        if coord is not None:
            ds = self._f.create_dataset(name, data=np.asarray(coord, dtype))
            ds.make_scale(name)
        else:
            ds = self._f.create_dataset(name, shape=(size,), dtype="f4")
            ds.make_scale(name)
            # After make_scale (which overwrites NAME with the plain dim
            # name): the anonymous marker is what tells netCDF4/xarray this
            # is a dimension without a coordinate variable, not f4 zeros.
            ds.attrs["NAME"] = np.bytes_(f"{_DIM_ANON} {size}".encode())
        ds.attrs["_Netcdf4Dimid"] = np.int32(self._dimid)
        self._dimid += 1
        self._dims[name] = ds
        return ds

    def def_var(self, name: str, data, dims: tuple[str, ...], compression: int = 0, attrs: Optional[dict] = None, dtype=None):
        """``data`` may be a numpy array or a torch tensor on any device: a
        tensor is pulled slab by slab straight into the dataset
        (``_stream_rows``).  ``dtype`` converts per slab (None keeps the
        input dtype)."""
        kwargs = {}
        ndim = getattr(data, "ndim", 0)
        if compression and ndim > 0:
            kwargs = dict(compression="gzip", compression_opts=int(compression), shuffle=True)
        in_dtype = _np_dtype(data)
        out_dtype = np.dtype(dtype) if dtype is not None else in_dtype
        if ndim > 0 and (not isinstance(data, np.ndarray) or out_dtype != in_dtype):
            ds = self._f.create_dataset(name, shape=tuple(data.shape), dtype=out_dtype, **kwargs)

            def store(i0, rows):
                ds[i0 : i0 + rows.shape[0]] = rows

            _stream_rows(data, out_dtype, store)
        else:
            ds = self._f.create_dataset(name, data=_to_host(data), **kwargs)
        for axis, dim in enumerate(dims):
            ds.dims[axis].attach_scale(self._dims[dim])
        for k, v in (attrs or {}).items():
            ds.attrs[k] = np.bytes_(v.encode()) if isinstance(v, str) else v
        return ds

    def def_var_empty(self, name: str, shape: tuple, dims: tuple[str, ...], dtype, compression: int = 0, attrs: Optional[dict] = None):
        """Define a data variable without writing values: the caller fills
        it later by slicing the returned h5py dataset (the windowed writers,
        where the whole array never exists)."""
        kwargs = {}
        if compression and len(shape) > 0:
            kwargs = dict(compression="gzip", compression_opts=int(compression), shuffle=True)
        ds = self._f.create_dataset(name, shape=shape, dtype=np.dtype(dtype), **kwargs)
        for axis, dim in enumerate(dims):
            ds.dims[axis].attach_scale(self._dims[dim])
        for k, v in (attrs or {}).items():
            ds.attrs[k] = np.bytes_(v.encode()) if isinstance(v, str) else v
        return ds

    def end_define(self):
        """Nothing to do: an HDF5 file takes definitions at any time (the
        classic ``ClassicStreamWriter`` writes its header here)."""

    def flush(self):
        self._f.flush()

    def set_attr(self, name: str, value):
        self._f.attrs[name] = np.bytes_(value.encode()) if isinstance(value, str) else value

    def set_dim_attrs(self, dim: str, attrs: dict):
        """Attach attributes (long_name, units, ...) to a coordinate variable."""
        ds = self._dims[dim]
        for k, v in attrs.items():
            ds.attrs[k] = np.bytes_(v.encode()) if isinstance(v, str) else v

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ClassicNetCDFWriter:
    """Classic NetCDF writer (scipy, 64-bit offsets) with NetCDFWriter's
    methods: the same dimensions, variables and attributes, without h5py.
    Classic NetCDF has no compression (``compression`` is ignored) and
    holds each variable in memory until ``close`` writes the file."""

    def __init__(self, path: str):
        from scipy.io import netcdf_file

        self._f = netcdf_file(path, "w", version=2)

    def def_dim(self, name: str, size: int, coord: Optional[np.ndarray] = None, dtype=None):
        self._f.createDimension(name, size)
        if coord is not None:
            coord = np.asarray(coord, dtype)
            var = self._f.createVariable(name, coord.dtype, (name,))
            var[:] = coord

    def def_var(self, name: str, data, dims: tuple[str, ...], compression: int = 0, attrs: Optional[dict] = None, dtype=None):
        out_dtype = np.dtype(dtype) if dtype is not None else _np_dtype(data)
        var = self._f.createVariable(name, out_dtype, dims)
        if getattr(data, "ndim", 0) > 0:

            def store(i0, rows):
                var[i0 : i0 + rows.shape[0]] = rows

            _stream_rows(data, out_dtype, store)
        else:
            var.assignValue(_to_host(data))
        for k, v in (attrs or {}).items():
            setattr(var, k, v)
        return var

    def set_attr(self, name: str, value):
        setattr(self._f, name, value)

    def set_dim_attrs(self, dim: str, attrs: dict):
        for k, v in attrs.items():
            setattr(self._f.variables[dim], k, v)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# Classic NetCDF (CDF-1/2) header tags and type codes, as the format's
# specification gives them.
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = b"\0\0\0\x0a", b"\0\0\0\x0b", b"\0\0\0\x0c"
_ABSENT = b"\0" * 8
_NC_CHARS = {1: "b", 2: "c", 3: "h", 4: "i", 5: "f", 6: "d"}  # nc_type -> numpy char
_NC_CODES = {("b", 1): 1, ("B", 1): 2, ("c", 1): 2, ("S", 1): 2, ("h", 2): 3,
             ("i", 4): 4, ("l", 4): 4, ("f", 4): 5, ("d", 8): 6}
#: The largest variable whose size a CDF-2 header states (vsize is 32-bit);
#: only the last variable may be larger, and its vsize then reads 2^32 - 1.
_VSIZE_MAX = 2**32 - 4
#: Bytes of the file a variable's slab write maps at a time.
MAP_BYTES = 32 * 2**20


def _be(dtype) -> np.dtype:
    return np.dtype(dtype).newbyteorder(">")


def _nc_name(name: str) -> bytes:
    raw = name.encode("latin1")
    return np.array(len(raw), ">i4").tobytes() + raw + b"\0" * (-len(raw) % 4)


def _nc_att(value) -> bytes:
    """One attribute's nc_type, count and values, encoded as scipy's
    ``netcdf_file`` encodes them: numpy values keep their type, a Python
    int is NC_INT, a float NC_FLOAT, a string NC_CHAR."""
    if hasattr(value, "dtype"):
        code = _NC_CODES[value.dtype.char, value.dtype.itemsize]
    else:
        sample = value
        if not isinstance(value, (str, bytes)):
            try:
                sample = value[0]
            except TypeError:
                pass
        code = next(c for cls, c in ((int, 4), (float, 5), (str, 2), (bytes, 2))
                    if isinstance(sample, cls))
    char = _NC_CHARS[code]
    arr = np.asarray(value, dtype="S" if char == "c" else ">" + char)
    raw = arr.tobytes()
    n = arr.itemsize if char == "c" else arr.size
    return np.array([code, n], ">i4").tobytes() + raw + b"\0" * (-len(raw) % 4)


def _nc_att_list(attrs: dict) -> bytes:
    if not attrs:
        return _ABSENT
    out = _NC_ATTRIBUTE + np.array(len(attrs), ">i4").tobytes()
    for k, v in attrs.items():
        out += _nc_name(k) + _nc_att(v)
    return out


class _Cursor:
    """Reads a classic header field by field."""

    def __init__(self, fh):
        self._fh = fh

    def raw(self, n: int) -> bytes:
        b = self._fh.read(n)
        if len(b) != n:
            raise ValueError("truncated classic NetCDF header")
        return b

    def int(self, width: int = 4) -> int:
        return int(np.frombuffer(self.raw(width), ">i4" if width == 4 else ">i8")[0])

    def name(self) -> str:
        n = self.int()
        s = self.raw(n)
        self.raw(-n % 4)
        return s.decode("latin1")

    def att_list(self) -> dict:
        tag, count = self.raw(4), self.int()
        if tag not in (_ABSENT[:4], _NC_ATTRIBUTE):
            raise ValueError("bad attribute list in a classic NetCDF header")
        out = {}
        for _ in range(count):
            key = self.name()
            char, n = _NC_CHARS[self.int()], self.int()
            nbytes = n * np.dtype(">" + char if char != "c" else "S1").itemsize
            raw = self.raw(nbytes)
            self.raw(-nbytes % 4)
            if char == "c":
                out[key] = raw.rstrip(b"\0")
            else:
                vals = np.frombuffer(raw, ">" + char).astype(char)
                out[key] = vals[0] if vals.shape == (1,) else vals
        return out


class ClassicVariable:
    """One fixed-size variable of a ``ClassicStreamWriter`` file: its shape,
    native dtype and attributes, its values (``np.asarray``), and hyperslab
    writes ``var[:, a:b(, :)] = block`` made in place."""

    def __init__(self, writer, name, dims, shape, dtype, attrs, values=None):
        self._w = writer
        self.name, self.dims, self.shape = name, tuple(dims), tuple(shape)
        self.dtype = np.dtype(dtype).newbyteorder("=")
        self.attrs = dict(attrs or {})
        self.values = values  # coordinate values, written with the header
        self.begin = None

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def _map(self, r0: int, r1: int) -> np.memmap:
        row = self.nbytes // max(self.shape[0], 1)
        return np.memmap(self._w._fh, dtype=_be(self.dtype), mode="r+",
                         offset=self.begin + r0 * row, shape=(r1 - r0,) + self.shape[1:])

    def __array__(self, dtype=None, copy=None):
        out = np.empty(self.shape, self.dtype)
        if self.shape[0]:
            out[...] = self._map(0, self.shape[0])
        return out if dtype is None else out.astype(dtype)

    def __setitem__(self, key, block) -> None:
        """Write ``block`` into the hyperslab ``key``: a slice of rows of
        the first dimension (step 1) and any basic index of the others,
        converted to the variable's type.  The file is mapped MAP_BYTES at a
        time, so a write holds no more of it than that in host memory."""
        key = key if isinstance(key, tuple) else (key,)
        start, stop, step = key[0].indices(self.shape[0])
        if step != 1:
            raise IndexError("a classic variable is written over a contiguous range of rows")
        block = np.asarray(block)
        rows = max(1, MAP_BYTES // max(self.nbytes // max(self.shape[0], 1), 1))
        for r0 in range(start, stop, rows):
            r1 = min(stop, r0 + rows)
            mm = self._map(r0, r1)
            mm[(slice(None),) + key[1:]] = block[r0 - start : r1 - start]
            del mm


class ClassicStreamWriter:
    """Classic NetCDF (CDF-2, 64-bit offsets) written in place, without h5py.

    Define the dimensions, coordinates and variables as with
    ``NetCDFWriter`` (``def_dim``, ``set_dim_attrs``, ``set_attr``,
    ``def_var_empty``), then ``end_define``: it writes the header and the
    coordinate values and sizes the file with ``truncate``, so the data
    variables start as holes of a sparse file.  Their hyperslabs are then
    written in place (``ClassicVariable.__setitem__``); ``flush`` makes the
    written slabs durable.  Nothing holds a whole variable in host memory,
    unlike ``ClassicNetCDFWriter`` (scipy), which writes at close.

    Coordinates come first and the data variables after them, in the order
    defined: CDF-2 states each variable's size in 32 bits, so only the last
    variable may exceed 4 GiB.  ``ClassicStreamWriter.open`` re-opens such a
    file for more writes (crash resume).
    """

    def __init__(self, path: str):
        self.path = path
        self._dims: dict = {}
        self._vars: dict = {}
        self._gatts: dict = {}
        self._fh = None

    # -- definition -----------------------------------------------------
    def def_dim(self, name: str, size: int, coord: Optional[np.ndarray] = None, dtype=None):
        self._dims[name] = int(size)
        if coord is not None:
            coord = np.asarray(coord, dtype)
            self._vars[name] = ClassicVariable(self, name, (name,), coord.shape, coord.dtype,
                                               None, coord)

    def def_var_empty(self, name: str, shape: tuple, dims: tuple[str, ...], dtype, compression: int = 0, attrs: Optional[dict] = None):
        """A variable filled later (classic NetCDF has no compression, so
        ``compression`` is ignored)."""
        if tuple(shape) != tuple(self._dims[d] for d in dims):
            raise ValueError(f"{name}: shape {tuple(shape)} does not match dims {dims}")
        var = ClassicVariable(self, name, dims, shape, dtype, attrs)
        self._vars[name] = var
        return var

    def set_attr(self, name: str, value):
        self._gatts[name] = value

    def set_dim_attrs(self, dim: str, attrs: dict):
        self._vars[dim].attrs.update(attrs)

    def end_define(self):
        """Write the header and the coordinates; size the file."""
        if self._fh is not None:
            return
        order = ([v for v in self._vars.values() if v.values is not None]
                 + [v for v in self._vars.values() if v.values is None])
        dim_ids = {d: i for i, d in enumerate(self._dims)}
        for v in order[:-1]:
            if v.nbytes > _VSIZE_MAX:
                raise ValueError(
                    f"{self.path}: {v.name} takes {v.nbytes} bytes; classic NetCDF (CDF-2) "
                    "holds one variable above 4 GiB, the last (install h5py for NETCDF4)"
                )

        def header(begins) -> bytes:
            out = b"CDF\x02" + np.array(0, ">i4").tobytes()
            if self._dims:
                out += _NC_DIMENSION + np.array(len(self._dims), ">i4").tobytes()
                for d, n in self._dims.items():
                    out += _nc_name(d) + np.array(n, ">i4").tobytes()
            else:
                out += _ABSENT
            out += _nc_att_list(self._gatts)
            if not order:
                return out + _ABSENT
            out += _NC_VARIABLE + np.array(len(order), ">i4").tobytes()
            for v, begin in zip(order, begins):
                size = v.nbytes + (-v.nbytes % 4)
                out += (_nc_name(v.name) + np.array(len(v.dims), ">i4").tobytes()
                        + np.array([dim_ids[d] for d in v.dims], ">i4").tobytes()
                        + _nc_att_list(v.attrs)
                        + np.array(_NC_CODES[v.dtype.char, v.dtype.itemsize], ">i4").tobytes()
                        + np.array(size if size <= _VSIZE_MAX else 2**32 - 1, ">u4").tobytes()
                        + np.array(begin, ">i8").tobytes())
            return out

        begins, at = [], len(header([0] * len(order)))
        for v in order:
            begins.append(at)
            at += v.nbytes + (-v.nbytes % 4)
        head = header(begins)
        self._fh = open(self.path, "w+b")
        self._fh.write(head)
        for v, begin in zip(order, begins):
            v.begin = begin
            if v.values is not None:
                self._fh.seek(begin)
                self._fh.write(np.ascontiguousarray(v.values, _be(v.dtype)).tobytes())
        self._fh.truncate(at)
        self._fh.flush()
        self._vars = {v.name: v for v in order}

    # -- data -----------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._vars

    def __getitem__(self, name: str) -> ClassicVariable:
        return self._vars[name]

    def flush(self):
        """Make every written slab durable (the checkpoint barrier)."""
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self):
        self.end_define()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @classmethod
    def open(cls, path: str) -> "ClassicStreamWriter":
        """Re-open a classic file of fixed-size variables for writing."""
        w = cls(path)
        w._fh = open(path, "r+b")
        try:
            cur = _Cursor(w._fh)
            if cur.raw(3) != b"CDF":
                raise ValueError(f"{path} is not a classic NetCDF file")
            width = {1: 4, 2: 8}[cur.raw(1)[0]]
            cur.int()  # numrecs
            tag, n_dims = cur.raw(4), cur.int()
            for _ in range(n_dims):
                name = cur.name()
                w._dims[name] = cur.int()
            w._gatts = cur.att_list()
            tag, n_vars = cur.raw(4), cur.int()
            dim_names = list(w._dims)
            for _ in range(n_vars):
                name = cur.name()
                dims = [dim_names[cur.int()] for _ in range(cur.int())]
                attrs = cur.att_list()
                char = _NC_CHARS[cur.int()]
                cur.int()  # vsize
                begin = cur.int(width)
                shape = tuple(w._dims[d] for d in dims)
                if any(n == 0 for n in shape):
                    raise ValueError(f"{path}: record variable {name!r} is not supported")
                var = ClassicVariable(w, name, dims, shape, char if char != "c" else "S1", attrs)
                var.begin = begin
                w._vars[name] = var
        except Exception:
            w._fh.close()
            raise
        return w


def output_format() -> str:
    """The NetCDF format of the outputs here: 'NETCDF4' (the JAX package's)
    where h5py is installed, 'classic' where it is not."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return "classic"
    return "NETCDF4"


def open_writer(path: str):
    """The writer of the outputs, in ``output_format()``."""
    return NetCDFWriter(path) if output_format() == "NETCDF4" else ClassicNetCDFWriter(path)


def open_windowed_writer(path: str):
    """The writer of a file filled window by window, in ``output_format()``:
    ``NetCDFWriter`` (its ``def_var_empty``) or ``ClassicStreamWriter``."""
    return NetCDFWriter(path) if output_format() == "NETCDF4" else ClassicStreamWriter(path)


def reopen_windowed(path: str):
    """An existing output file opened for more windows (crash resume), in
    the file's own format: an h5py ``File`` or a ``ClassicStreamWriter``.
    Both index variables by name and write ``var[:, a:b] = block``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"resume requested but output file is missing: {path}")
    with open(path, "rb") as fh:
        classic = fh.read(3) == b"CDF"
    if classic:
        return ClassicStreamWriter.open(path)
    import h5py

    return h5py.File(path, "r+")


def read_netcdf(path: str, names) -> tuple:
    """({name: array} of the variables ``names``, global attributes) of a
    NETCDF4 or classic file."""
    with open(path, "rb") as fh:
        classic = fh.read(3) == b"CDF"
    if classic:
        from scipy.io import netcdf_file

        def native(a):  # classic NetCDF is big-endian
            return a.astype(a.dtype.newbyteorder("="))

        with netcdf_file(path, "r", mmap=False) as f:
            return {n: native(f.variables[n][:]) for n in names}, dict(f._attributes)
    import h5py

    with h5py.File(path, "r") as f:
        return {n: np.asarray(f[n]) for n in names}, dict(f.attrs)


def write_grid_forcing(
    path: str,
    var_name: str,
    data: np.ndarray,
    time_vals: Optional[np.ndarray] = None,
    lat_vals: Optional[np.ndarray] = None,
    lon_vals: Optional[np.ndarray] = None,
    attrs: Optional[dict] = None,
    time_attrs: Optional[dict] = None,
    writer=NetCDFWriter,
) -> None:
    """Write a (time, lat, lon) float32 forcing grid (ERA5-Land-shaped), as
    NETCDF4, or as classic NetCDF with ``writer=ClassicNetCDFWriter``.

    ``time_attrs`` (e.g. {"units": "hours since 2019-01-01"}) enables dt
    inference by forcing folder discovery.
    """
    data = np.asarray(data, np.float32)
    n_t, n_lat, n_lon = data.shape
    with writer(path) as w:
        w.def_dim("time", n_t, time_vals, "f8")
        w.def_dim("lat", n_lat, lat_vals, "f8")
        w.def_dim("lon", n_lon, lon_vals, "f8")
        if time_attrs:
            w.set_dim_attrs("time", time_attrs)
        w.def_var(var_name, data, ("time", "lat", "lon"), attrs=attrs)
