"""The port's offline preprocessing path (``mammo_clip_tpu_torch/preprocess``,
``data/png.py``, ``data/images.py``) against the JAX package and OpenCV, on
the CPU at small sizes (mammograms ~300x200, DICOM fixtures 128x96):

* ``breast_crop`` bit-equal to JAX's (left and right breasts, MONOCHROME1 and
  2, a tie between two equal runs, an all-background image);
* the native library (built with g++ into ``mammo_clip_tpu_torch/build/``):
  crop bounds equal to JAX's numpy, normalize bit-equal to its plain version,
  the fused pipeline's resize within 1 of its plain version; the area resize
  and CLAHE within 1 of cv2 (JAX's own tolerances);
* the PNG decoder bit-equal to ``cv2.imread`` on cv2-written files (all five
  row filters among them), the encoder read back by cv2, and the types it does
  not read refused by name;
* ``DirectoryImageStore`` against JAX's (cv2): bit-equal without a resize,
  within 1 with one;
* ``write_packed_shards`` against JAX's on one loader: the same shard and
  ``index.csv`` bytes at n < shard_size, n = 2 * shard_size and
  2 * shard_size + 1, read back through both stores;
* the DICOM codec, pool and tool, behind a GDCM fixture (the port builds its
  own library; no test here touches the JAX package's native bindings, whose
  first use runs ``make`` inside the JAX tree);
* the pretraining dataset over the port's rows and shards against JAX's over
  JAX's; one tiny ``cli/pretrain`` step and one tiny ``cli/detector`` epoch on
  shards, CSVs and boxes written by the port.
"""

import csv
import json
import math
import re
import struct
import zlib

import numpy as np
import pandas as pd
import pytest
import torch

from mammo_clip_tpu.data import datasets as jax_ds
from mammo_clip_tpu.data import images as jax_images
from mammo_clip_tpu.data.metadata import load_metadata as jax_load_metadata
from mammo_clip_tpu.preprocess import breast_crop as jax_crop
from mammo_clip_tpu.preprocess import shard_writer as jax_shards
from mammo_clip_tpu.preprocess import text as jax_text
from mammo_clip_tpu_torch.data import datasets, images, png
from mammo_clip_tpu_torch.data.metadata import Table, load_metadata, write_table
from mammo_clip_tpu_torch.preprocess import breast_crop, native_bindings as nb
from mammo_clip_tpu_torch.preprocess import shard_writer, text, vindr_csv

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mammogram(h=300, w=200, side="left", seed=0):
    """Black background + a bright textured half-ellipse 'breast' on one side."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    cx = 0 if side == "left" else w - 1
    mask = ((xx - cx) / (w * 0.55)) ** 2 + ((yy - h / 2) / (h * 0.45)) ** 2 < 1
    img[mask] = 100 + rng.integers(0, 100, int(mask.sum())).astype(np.uint8)
    return img


def _raw(side="left", seed=0, h=300, w=200):
    """uint16 detector values: the breast plus low noise everywhere."""
    rng = np.random.default_rng(seed + 100)
    base = _mammogram(h, w, side, seed).astype(np.uint16) * 40
    return base + rng.integers(0, 30, (h, w)).astype(np.uint16)


def _tie():
    """Two textured column runs of equal length (10): the first wins."""
    rng = np.random.default_rng(2)
    img = np.zeros((60, 50), np.uint8)
    img[:, 5:15] = rng.integers(41, 255, (60, 10))
    img[:, 25:35] = rng.integers(41, 255, (60, 10))
    return img


CROP_CASES = {
    "left": lambda: _mammogram(side="left"),
    "right": lambda: _mammogram(side="right", seed=1),
    "tie": _tie,
    "background": lambda: np.full((40, 30), 17, np.uint8),
}


@pytest.fixture(scope="module")
def native():
    if not nb.native_available():
        pytest.skip("no C++ compiler")
    return nb


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_breast_crop_matches_jax(case, native):
    img = CROP_CASES[case]()
    bounds = breast_crop.breast_roi_bounds(img)
    assert bounds == jax_crop.breast_roi_bounds(img)
    assert native.breast_crop_bounds_native(img) == bounds
    np.testing.assert_array_equal(breast_crop.extract_breast_roi(img),
                                  jax_crop.extract_breast_roi(img))
    if case == "tie":
        assert bounds[2:] == (5, 15)
    if case == "background":
        assert bounds == (0, 40, 0, 30)
    boxes = np.asarray([[3.5, 7.0, 40.25, 33.0], [0.0, 0.0, 1e4, 1e4]])
    for out_size in ((64, 48), (512, 512)):
        np.testing.assert_array_equal(breast_crop.remap_boxes(boxes, bounds, out_size),
                                      jax_crop.remap_boxes(boxes, bounds, out_size))


@pytest.mark.parametrize("photometric", ["MONOCHROME1", "MONOCHROME2"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_normalize_and_bounds_match_jax(photometric, side, native):
    """normalize_dicom_pixels (trim, invert first, truncate) bit-equal to JAX's;
    the native bounds of its output equal to JAX's numpy bounds; the native
    normalize (invert after scaling, +0.5) bit-equal to its plain version and
    within one grey level of normalize_dicom_pixels."""
    raw = _raw(side, seed=3)
    for trim in (0, 5):
        ours = breast_crop.normalize_dicom_pixels(raw, photometric, trim)
        want = jax_crop.normalize_dicom_pixels(raw, photometric, trim)
        np.testing.assert_array_equal(ours, want)
        assert native.breast_crop_bounds_native(ours) == jax_crop.breast_roi_bounds(want)
    invert = photometric == "MONOCHROME1"
    nat = native.normalize_native(raw, invert)
    np.testing.assert_array_equal(nat, nb.normalize_u16_to_u8_plain(raw, invert))
    diff = nat.astype(int) - breast_crop.normalize_dicom_pixels(raw, photometric, 0)
    assert np.abs(diff).max() <= 1


@pytest.mark.parametrize("out_size", [(152, 91), (64, 64), (400, 260)])
def test_fused_pipeline_matches_plain(out_size, native):
    for side, invert in (("left", False), ("right", True)):
        raw = _raw(side, seed=5)
        img, bounds = native.preprocess_mammogram_native(raw, out_size, invert)
        ref, ref_bounds = nb.preprocess_mammogram_plain(raw, out_size, invert)
        assert bounds == ref_bounds
        assert bounds == jax_crop.breast_roi_bounds(nb.normalize_u16_to_u8_plain(raw, invert))
        assert img.shape == out_size and np.abs(img.astype(int) - ref).max() <= 1
        assert img.max() > 100


def test_area_resize_and_clahe_match_cv2(native):
    """JAX's tolerances (tests/test_preprocess.py): within 1 of cv2's
    INTER_AREA and CLAHE, for the native functions and their plain versions."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (97, 61), dtype=np.uint8)
    ref = cv2.resize(img, (30, 48), interpolation=cv2.INTER_AREA)
    for ours in (native.area_resize_native(img, (48, 30)), nb.area_resize_plain(img, (48, 30))):
        assert np.abs(ours.astype(int) - ref).max() <= 1
    np.testing.assert_array_equal(native.area_resize_native(img, (48, 30)),
                                  nb.area_resize_plain(img, (48, 30)))
    rng = np.random.default_rng(3)
    img = np.ascontiguousarray(rng.normal(120, 30, (256, 192)).clip(0, 255).astype(np.uint8))
    ref = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(img)
    ours = native.clahe_native(img, tiles=(8, 8), clip_limit=2.0)
    assert np.abs(ours.astype(int) - ref).max() <= 1
    assert np.abs(nb.clahe_plain(img).astype(int) - ours).max() <= 1
    assert np.std(np.bincount(ours.ravel(), minlength=256)) < np.std(
        np.bincount(img.ravel(), minlength=256))


# ------------------------------------------------------------------ PNG


def _png_images():
    rng = np.random.default_rng(6)
    h, w = 48, 40
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((np.sin(yy / 9.0) + np.cos(xx / 7.0)) * 60 + 128).astype(np.uint8)
    noisy = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mixed = np.clip(smooth.astype(int) + rng.integers(-6, 7, (h, w)), 0, 255).astype(np.uint8)
    return {"smooth": smooth, "noisy": noisy, "mixed": mixed}


def _filter_bytes(data: bytes) -> set:
    pos, idat = 8, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h = struct.unpack(">II", data[pos + 8:pos + 16])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (w + 1)] for y in range(h)}


def test_png_decoder_matches_cv2(native, monkeypatch):
    seen = set()
    for name, img in _png_images().items():
        for level in (0, 3, 9):
            ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            data = buf.tobytes()
            seen |= _filter_bytes(data)
            ref = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(png.decode_png(data), ref)
            with monkeypatch.context() as m:  # the no-compiler path
                m.setattr(nb, "native_available", lambda: False)
                np.testing.assert_array_equal(png.decode_png(data), ref)
    assert seen == {0, 1, 2, 3, 4}, seen


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_encoder_round_trips_through_cv2(tmp_path, filters, monkeypatch):
    """Each row filter of the encoder, alone and cycled: cv2 reads the file
    back bit for bit, and so do the decoder's native and plain unfilters."""
    for name, img in _png_images().items():
        for level in (0, 6, 9):
            path = tmp_path / f"{name}{level}.png"
            png.write_png(path, img, level, filters)
            assert _filter_bytes(path.read_bytes()) == set(filters)
            np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), img)
            np.testing.assert_array_equal(png.read_png(path), img)
            with monkeypatch.context() as m:
                m.setattr(nb, "native_available", lambda: False)
                np.testing.assert_array_equal(png.read_png(path), img)


def _reheader(data: bytes, **fields) -> bytes:
    """The PNG with IHDR fields replaced (bit_depth, colour, interlace)."""
    body = bytearray(data[16:29])
    for key, off in (("bit_depth", 8), ("colour", 9), ("interlace", 12)):
        if key in fields:
            body[off] = fields[key]
    body = bytes(body)
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


def test_png_refuses_what_it_does_not_read(tmp_path):
    img = _png_images()["smooth"]
    rgb = cv2.imencode(".png", np.stack([img] * 3, -1))[1].tobytes()
    grey16 = cv2.imencode(".png", img.astype(np.uint16) * 257)[1].tobytes()
    ours = png.encode_png(img)
    for data, words in ((rgb, "colour type 2 (truecolour)"), (grey16, "bit depth 16"),
                        (_reheader(ours, interlace=1), "Adam7"),
                        (_reheader(ours, colour=4), "colour type 4 (greyscale with alpha)"),
                        (ours[:-3], "truncated"), (b"GIF89a" + ours[6:], "not a PNG")):
        with pytest.raises(ValueError, match=re.escape(words)):
            png.decode_png(data)
    bad = bytearray(ours)
    bad[40] ^= 0xFF  # inside the IDAT body
    with pytest.raises(ValueError, match="bad CRC"):
        png.decode_png(bytes(bad))
    # an unknown filter type byte
    raw = bytes([5]) + img[0].tobytes() + b"".join(bytes([0]) + r.tobytes() for r in img[1:])
    h, w = img.shape
    for fn in (nb.png_unfilter, nb.png_unfilter_plain):
        with pytest.raises(ValueError, match="filter type 5"):
            fn(raw, h, w)
    with pytest.raises(FileNotFoundError):
        images.DirectoryImageStore(str(tmp_path)).get("s", "missing.png")


def test_directory_store_matches_jax(tmp_path):
    """The reference's tree (root/<study>/<image>.png), written by cv2 and by the
    port: the port's store equals JAX's (cv2) bit for bit without a resize and
    within 1 with one; open_image_store picks it for a tree without index.csv."""
    for i, (name, img) in enumerate(_png_images().items()):
        (tmp_path / f"s{i}").mkdir()
        big = cv2.resize(img, (200, 240), interpolation=cv2.INTER_LINEAR)
        cv2.imwrite(str(tmp_path / f"s{i}" / f"{name}.png"), big)
        png.write_png(tmp_path / f"s{i}" / f"{name}_port.png", big)
    store = images.open_image_store(str(tmp_path))
    assert isinstance(store, images.DirectoryImageStore)
    for size, tol in ((None, 0), ((120, 100), 1), ((64, 48), 1), ((240, 200), 0)):
        ours = images.DirectoryImageStore(str(tmp_path), size)
        ref = jax_images.DirectoryImageStore(str(tmp_path), size)
        for i, name in enumerate(_png_images()):
            for f in (f"{name}.png", f"{name}_port.png"):
                got, want = ours.get(f"s{i}", f), ref.get(f"s{i}", f)
                assert got.shape == want.shape and got.dtype == np.uint8
                assert np.abs(got.astype(int) - want).max() <= tol
                if size is not None and size != (240, 200):
                    np.testing.assert_array_equal(
                        got, nb.area_resize(images.DirectoryImageStore(str(tmp_path)).get(
                            f"s{i}", f), size))


# ------------------------------------------------------------------ shards


@pytest.mark.parametrize("n", [5, 8, 9])
def test_shard_writer_matches_jax(n, tmp_path):
    """shard_size 4: n < shard_size... 5 is one full shard and one of 1; 8 two
    full shards; 9 two and one of 1. Same loader on both sides."""
    rng = np.random.default_rng(n)
    h, w = 24, 16
    ims = {f"id,{k}" if k == 2 else str(k * 7): rng.integers(0, 255, (h, w), dtype=np.uint8)
           for k in range(n)}
    pairs = [(k, k) for k in ims]
    shard_size = 4 if n > 5 else 8
    ours = shard_writer.write_packed_shards(pairs, str(tmp_path / "port"), (h, w), shard_size,
                                            loader=ims.__getitem__)
    ref = jax_shards.write_packed_shards(pairs, str(tmp_path / "jax"), (h, w), shard_size,
                                         loader=ims.__getitem__)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files
    assert len(files) == 1 + -(-n // shard_size)
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert list(ours.columns) == list(ref.columns)
    assert [list(r.values()) for r in ours] == ref.values.tolist()
    for store in (images.open_image_store(str(tmp_path / "port")),
                  jax_images.open_image_store(str(tmp_path / "port"))):
        for k, v in ims.items():
            np.testing.assert_array_equal(store.get("", k), v)


def test_default_loader_matches_jax(tmp_path):
    """The PNG loader (port: its decoder and area resize; JAX: cv2), with and
    without the breast crop: within 1 grey level, same shape."""
    paths = []
    for i, side in enumerate(("left", "right")):
        paths.append(str(tmp_path / f"m{i}.png"))
        png.write_png(paths[-1], _mammogram(side=side, seed=i))
    for crop in (False, True):
        for size in ((150, 100), (300, 200)):
            for p in paths:
                got = shard_writer.default_image_loader(p, size, crop)
                want = jax_shards.default_image_loader(p, size, crop)
                assert got.shape == size and np.abs(got.astype(int) - want).max() <= 1


# ------------------------------------------------------------------ DICOM


@pytest.fixture(scope="module")
def dicom():
    from mammo_clip_tpu_torch.preprocess import dicom_native as dn

    if not dn.dicom_available():
        pytest.skip("no GDCM headers or C++ compiler")
    return dn


def _dicom_dir(dn, root, n=6, h=128, w=96):
    root.mkdir()
    syntaxes = [dn.TS_J2K, dn.TS_JPEG_LOSSLESS, dn.TS_JLS, dn.TS_RAW]
    for i in range(n):
        raw = _raw("left" if i % 2 else "right", seed=i, h=h + 2 * i, w=w)
        dn.write_dicom_u16(str(root / f"case{i}.dicom"), raw, ts=syntaxes[i % 4],
                           monochrome1=i % 3 == 0)
    return root


def test_dicom_round_trip_all_syntaxes(dicom, tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 4096, (128, 96)).astype(np.uint16)
    for ts in (dicom.TS_RAW, dicom.TS_J2K, dicom.TS_JLS, dicom.TS_JPEG_LOSSLESS):
        for mono1 in (False, True):
            p = str(tmp_path / f"t{ts}_{mono1}.dcm")
            dicom.write_dicom_u16(p, img, ts=ts, monochrome1=mono1)
            out, got_mono1 = dicom.read_dicom_u16(p)
            np.testing.assert_array_equal(out, img)
            assert got_mono1 == mono1


def test_dicom_pool_matches_serial_path(dicom, tmp_path):
    from mammo_clip_tpu_torch.preprocess import dicom_tool

    paths = sorted(str(p) for p in _dicom_dir(dicom, tmp_path / "d").iterdir())
    out_size = (96, 64)
    serial = [dicom_tool.convert_one(p, out_size) for p in paths]
    for n_threads in (1, 3):
        imgs, bounds, status = dicom.batch_preprocess(paths, out_size, n_threads=n_threads)
        assert status.tolist() == [0] * len(paths)
        for i in range(len(paths)):
            np.testing.assert_array_equal(imgs[i], serial[i][0])
            assert tuple(bounds[i]) == tuple(serial[i][1])
    bad = str(tmp_path / "broken.dicom")
    with open(bad, "wb") as f:
        f.write(b"not a dicom at all")
    imgs, _, status = dicom.batch_preprocess([paths[0], bad, paths[1]], out_size, n_threads=2)
    assert status[0] == 0 and status[2] == 0 and status[1] != 0
    np.testing.assert_array_equal(imgs[2], serial[1][0])


def test_dicom_tool_pool_serial_and_png(dicom, tmp_path):
    """--threads 0 (the pool) and --threads 1 (serial) write the same shard and
    index bytes and the same bounds CSV, whose bytes are pandas'; --png writes
    the same pixels as PNGs that cv2 reads."""
    from mammo_clip_tpu_torch.preprocess import dicom_tool

    in_dir = _dicom_dir(dicom, tmp_path / "d")
    outs = {}
    for threads in ("0", "1"):
        out = tmp_path / f"shards{threads}"
        dicom_tool.main(["--in-dir", str(in_dir), "--out-dir", str(out), "--height", "80",
                         "--width", "56", "--threads", threads, "--bounds-csv",
                         str(tmp_path / f"b{threads}.csv")])
        outs[threads] = {p.name: p.read_bytes() for p in out.iterdir()}
    assert outs["0"] == outs["1"]
    assert (tmp_path / "b0.csv").read_bytes() == (tmp_path / "b1.csv").read_bytes()
    with open(tmp_path / "b0.csv", newline="") as f:
        rows = [{k: (v if k == "image_id" else int(v)) for k, v in r.items()}
                for r in csv.DictReader(f)]
    assert [r["image_id"] for r in rows] == [f"case{i}" for i in range(6)]
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "pandas.csv").read_bytes() == (tmp_path / "b0.csv").read_bytes()
    dicom_tool.main(["--in-dir", str(in_dir), "--out-dir", str(tmp_path / "pngs"),
                     "--height", "80", "--width", "56", "--png"])
    store = images.open_image_store(str(tmp_path / "shards0"))
    for i in range(6):
        ref = cv2.imread(str(tmp_path / "pngs" / f"case{i}.png"), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(store.get("", f"case{i}"), ref)


# ------------------------------------------------------------------ into training


def _reports(n_patients):
    rows = []
    for i in range(n_patients):
        for view in ("CC", "MLO"):
            rows.append({"patient_id": str(10 + i), "laterality": "LR"[i % 2],
                         "image_id": f"{10 + i}_{view}", "view_position": view,
                         "findings": f"There is a mass in sample {i}. Calcifications are seen "
                                     f"in the {view} view.",
                         "impressions": "No evidence of malignancy is seen here."})
    return rows


@pytest.fixture(scope="module")
def written(tmp_path_factory, native):
    """Report rows -> the pretraining CSV (port: build_pretrain_rows,
    assign_group_folds, augment_pretrain_csv, write_table; JAX: the same on
    pandas), and raw mammograms -> 32x32 and 64x64 shards (both writers, one
    loader: the native fused pipeline) with their crop bounds."""
    root = tmp_path_factory.mktemp("written")
    report_path = root / "reports.csv"
    with open(report_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(_reports(1)[0]))
        w.writeheader()
        w.writerows(_reports(4))

    class NoWeights:
        available = False

    tab = text.build_pretrain_rows(load_metadata(str(report_path)), view_col="view_position")
    tab = text.augment_pretrain_csv(text.assign_group_folds(tab, n_folds=2), NoWeights())
    write_table(tab, str(root / "pretrain.csv"))
    df = jax_text.build_pretrain_rows(jax_load_metadata(str(report_path)),
                                      view_col="view_position")
    df = jax_text.augment_pretrain_csv(jax_text.assign_group_folds(df, n_folds=2), NoWeights())
    df.to_csv(root / "pretrain_jax.csv", index=False)
    raws = {r["image_id"]: _raw("left" if k % 2 else "right", seed=k)
            for k, r in enumerate(_reports(4))}
    bounds = {}

    def loader(size):
        def load(image_id):
            img, bounds[image_id] = nb.preprocess_mammogram_native(raws[image_id], size)
            return img
        return load

    pairs = [(k, k) for k in raws]
    for size in ((32, 32), (64, 64)):
        shard_writer.write_packed_shards(pairs, str(root / f"port{size[0]}"), size, 3,
                                         loader=loader(size))
        jax_shards.write_packed_shards(pairs, str(root / f"jax{size[0]}"), size, 3,
                                       loader=loader(size))
    return root, bounds


def test_written_files_match_jax(written):
    root, _ = written
    assert (root / "pretrain.csv").read_bytes() == (root / "pretrain_jax.csv").read_bytes()
    for size in (32, 64):
        for f in (root / f"jax{size}").iterdir():
            assert (root / f"port{size}" / f.name).read_bytes() == f.read_bytes()


@pytest.mark.parametrize("split", ["train", "valid"])
def test_pretrain_dataset_items_match_jax(written, split):
    root, _ = written
    ours = datasets.ImageTextDataset(load_metadata(str(root / "pretrain.csv")),
                                     images.open_image_store(str(root / "port64")), split=split,
                                     seed=3)
    ref = jax_ds.ImageTextDataset(jax_load_metadata(str(root / "pretrain_jax.csv")),
                                  jax_images.open_image_store(str(root / "jax64")), split=split,
                                  seed=3)
    assert len(ours) == len(ref) == 4
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]


def test_pretrain_cli_step_on_port_shards(written, tmp_path):
    from mammo_clip_tpu_torch.cli import pretrain

    root, _ = written
    entry = json.dumps([{"csv": str(root / "pretrain.csv"), "image_dir": str(root / "port32")}])
    tiny = ["model.image_encoder.name=efficientnet-b0", "data.image_size_h=32",
            "data.image_size_w=32", "data.text_max_length=8",
            "model.text_encoder.num_layers=1", "model.text_encoder.hidden_size=16",
            "model.text_encoder.num_heads=2", "model.text_encoder.intermediate_size=32",
            "model.text_encoder.vocab_size=64", "model.projection_head.proj_dim=8",
            f"data.train={entry}", f"data.valid={entry}", "data.batch_size_per_device=2",
            "scheduler.warmup_epochs=0", "scheduler.epochs=1", "train.dtype=float32",
            "train.log_every=1"]
    work = tmp_path / "run"
    state = pretrain.main(["--device", "cpu", "--workdir", str(work), "--variant", "b2"] + tiny)
    assert state.step == 1  # 2 training rows (fold 1) at batch 2
    rows = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    assert {r["prefix"] for r in rows} == {"train", "valid"}
    assert all(math.isfinite(r["loss/total"]) for r in rows)


def test_detector_cli_epoch_on_port_shards(written, tmp_path):
    """Boxes drawn in the original frame, rescaled by rescale_detection_boxes
    through the pipeline's bounds into the 64x64 shards' frame."""
    from mammo_clip_tpu_torch.cli import detector
    from mammo_clip_tpu_torch.core.config import tiny_test_config
    from mammo_clip_tpu_torch.models import build_model
    from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
    from mammo_clip_tpu_torch.train.checkpoint import load_checkpoint_arrays, save_checkpoint

    root, bounds = written
    cfg = tiny_test_config()
    model = build_model(cfg.model.to_dict(), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    opt = build_optimizer(cfg.optimizer.to_dict(), lambda s: 1e-4, model.named_parameters())
    save_checkpoint(str(tmp_path / "clip" / "best"), create_train_state(model, opt),
                    config=cfg.to_dict(), step=1)
    ann = []
    for k, image_id in enumerate(sorted(bounds)):
        y0, y1, x0, x1 = bounds[image_id]
        ann.append({"study_id": image_id.split("_")[0], "image_id": image_id,
                    "finding_categories": str(["Mass"]), "xmin": float(x0 + 10 + k),
                    "ymin": float(y0 + 20), "xmax": float(x0 + 60 + k), "ymax": float(y0 + 90),
                    "split": "training" if k < 6 else "test"})
    ann_tab = Table(ann, list(ann[0]))
    bounds_tab = Table([{"image_id": i, "y0": b[0], "y1": b[1], "x0": b[2], "x1": b[3]}
                        for i, b in bounds.items()], ["image_id", "y0", "y1", "x0", "x1"])
    det = vindr_csv.rescale_detection_boxes(ann_tab, bounds_tab, out_size=(64, 64))
    for r in det:
        assert 0 <= r["resized_xmin"] < r["resized_xmax"] <= 63
        assert 0 <= r["resized_ymin"] < r["resized_ymax"] <= 63
    write_table(det, str(tmp_path / "det.csv"))
    res = detector.main(["--clip-checkpoint", str(tmp_path / "clip" / "best"), "--csv",
                         str(tmp_path / "det.csv"), "--image-dir", str(root / "port64"),
                         "--resize", "64", "--batch-size", "3", "--epochs", "1", "--device",
                         "cpu", "--workdir", str(tmp_path / "det")])
    assert math.isfinite(res["best_mAP"]) and 0.0 <= res["best_mAP"] <= 1.0
    arrays = load_checkpoint_arrays(str(tmp_path / "det" / "best"))
    assert arrays["scores"].shape[0] == 2  # every validation image scored
