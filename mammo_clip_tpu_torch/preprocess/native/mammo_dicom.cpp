// First-party DICOM pixel I/O (a copy of mammo_clip_tpu/preprocess/native/
// mammo_dicom.cpp), built on the system GDCM 3.0
// C++ toolkit (headers in /usr/include/gdcm-3.0; codecs: OpenJPEG for JPEG-2000,
// CharLS for JPEG-LS, IJG 12/16-bit for JPEG Lossless).
//
// This replaces the reference's third-party decode paths — NVIDIA DALI GPU JPEG2000
// (reference: src/preprocessing/preprocess_image_to_png_kaggle.py:95-100) and
// dicomsdl (preprocess_image_to_png_vindr.py:80-88) — with a native decoder the
// package owns, so preprocess/dicom_tool.py runs end-to-end without pydicom.
// The RSNA mammography DICOMs are JPEG-2000 lossless; VinDr's are JPEG Lossless
// (process 14 SV1) — both covered here, plus JPEG-LS and uncompressed syntaxes.
//
// dicom_write_u16 exists for the test suite: it synthesizes DICOM files in each
// transfer syntax (GDCM encodes as well as decodes), so decode is provable offline
// without shipping dataset files.
//
// Built at first use by preprocess/dicom_native.py, into one library with
// mammo_pool.cpp and mammo_native.cpp (g++ -I$GDCM_INC, linked to GDCM).

#include <cstdint>
#include <cstring>
#include <vector>

#include <gdcmAttribute.h>
#include <gdcmImage.h>
#include <gdcmImageChangeTransferSyntax.h>
#include <gdcmImageReader.h>
#include <gdcmImageWriter.h>
#include <gdcmPhotometricInterpretation.h>
#include <gdcmPixelFormat.h>
#include <gdcmTransferSyntax.h>

namespace {

// error codes shared with preprocess/dicom_native.py
enum Status {
  kOk = 0,
  kReadFailed = 1,
  kUnsupportedFormat = 2,
  kBufferMismatch = 3,
  kWriteFailed = 4,
};

gdcm::TransferSyntax::TSType ts_from_code(int code) {
  switch (code) {
    case 1: return gdcm::TransferSyntax::JPEG2000Lossless;
    case 2: return gdcm::TransferSyntax::JPEGLSLossless;
    case 3: return gdcm::TransferSyntax::JPEGLosslessProcess14_1;
    default: return gdcm::TransferSyntax::ExplicitVRLittleEndian;
  }
}

}  // namespace

extern "C" {

// Query geometry/format. rows/cols; bits_allocated in {8, 16}; is_signed;
// monochrome1 = needs inversion. Returns a Status.
int dicom_image_info(const char* path, int64_t* rows, int64_t* cols,
                     int* bits_allocated, int* is_signed, int* monochrome1) {
  gdcm::ImageReader reader;
  reader.SetFileName(path);
  if (!reader.Read()) return kReadFailed;
  const gdcm::Image& img = reader.GetImage();
  const unsigned int* dims = img.GetDimensions();
  *cols = dims[0];
  *rows = dims[1];
  const gdcm::PixelFormat& pf = img.GetPixelFormat();
  *bits_allocated = pf.GetBitsAllocated();
  *is_signed = pf.GetPixelRepresentation() ? 1 : 0;
  *monochrome1 = img.GetPhotometricInterpretation() ==
                         gdcm::PhotometricInterpretation::MONOCHROME1
                     ? 1
                     : 0;
  if (pf.GetSamplesPerPixel() != 1) return kUnsupportedFormat;
  if (*bits_allocated != 8 && *bits_allocated != 16) return kUnsupportedFormat;
  return kOk;
}

// Decode pixels into a caller-allocated uint16 buffer of rows*cols elements.
// 8-bit data is widened; signed 16-bit is shifted by +32768 (order-preserving —
// downstream normalization is per-image min-max, preprocess_image_to_png_vindr.py:84-90).
int dicom_read_u16(const char* path, uint16_t* out, int64_t out_elems) {
  gdcm::ImageReader reader;
  reader.SetFileName(path);
  if (!reader.Read()) return kReadFailed;
  const gdcm::Image& img = reader.GetImage();
  const unsigned int* dims = img.GetDimensions();
  const int64_t n = int64_t(dims[0]) * dims[1];
  if (n != out_elems) return kBufferMismatch;
  const gdcm::PixelFormat& pf = img.GetPixelFormat();
  const int bits = pf.GetBitsAllocated();
  const bool sign = pf.GetPixelRepresentation() != 0;

  std::vector<char> buf(img.GetBufferLength());
  if (!img.GetBuffer(buf.data())) return kReadFailed;

  if (bits == 8) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(buf.data());
    for (int64_t i = 0; i < n; ++i) out[i] = src[i];
  } else if (bits == 16 && !sign) {
    std::memcpy(out, buf.data(), size_t(n) * 2);
  } else if (bits == 16 && sign) {
    const int16_t* src = reinterpret_cast<const int16_t*>(buf.data());
    for (int64_t i = 0; i < n; ++i) out[i] = uint16_t(int32_t(src[i]) + 32768);
  } else {
    return kUnsupportedFormat;
  }
  return kOk;
}

// Encode a uint16 image as a monochrome DICOM file. ts_code: 0 = explicit-VR
// little-endian (uncompressed), 1 = JPEG-2000 lossless, 2 = JPEG-LS lossless,
// 3 = JPEG Lossless process 14 SV1. Used by tests to synthesize fixtures in the
// exact transfer syntaxes the RSNA/VinDr datasets use.
int dicom_write_u16(const char* path, const uint16_t* pixels, int rows, int cols,
                    int ts_code, int monochrome1) {
  gdcm::ImageWriter writer;
  gdcm::Image& image = writer.GetImage();
  image.SetNumberOfDimensions(2);
  image.SetDimension(0, cols);
  image.SetDimension(1, rows);
  gdcm::PixelFormat pf(gdcm::PixelFormat::UINT16);
  image.SetPixelFormat(pf);
  image.SetPhotometricInterpretation(
      monochrome1 ? gdcm::PhotometricInterpretation::MONOCHROME1
                  : gdcm::PhotometricInterpretation::MONOCHROME2);
  image.SetTransferSyntax(gdcm::TransferSyntax::ExplicitVRLittleEndian);

  gdcm::DataElement pixeldata(gdcm::Tag(0x7fe0, 0x0010));
  pixeldata.SetByteValue(reinterpret_cast<const char*>(pixels),
                         uint32_t(int64_t(rows) * cols * 2));
  image.SetDataElement(pixeldata);

  // Modality MG -> mammography MediaStorage, so PhotometricInterpretation (the
  // MONOCHROME1 inversion flag the tool depends on) is serialized.
  gdcm::Attribute<0x0008, 0x0060> modality;
  modality.SetValue("MG");
  writer.GetFile().GetDataSet().Replace(modality.GetAsDataElement());

  writer.SetFileName(path);
  if (ts_code == 0) {
    return writer.Write() ? kOk : kWriteFailed;
  }
  gdcm::ImageChangeTransferSyntax change;
  change.SetTransferSyntax(gdcm::TransferSyntax(ts_from_code(ts_code)));
  change.SetInput(image);
  if (!change.Change()) return kWriteFailed;
  writer.SetImage(const_cast<gdcm::Image&>(change.GetOutput()));
  return writer.Write() ? kOk : kWriteFailed;
}

}  // extern "C"
