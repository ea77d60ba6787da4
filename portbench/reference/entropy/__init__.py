"""The reference's entropy decoders, one file each: a file names the
entropy ids it decodes (IDS) and gives decode(bits, length); where the
codec has a device decode kernel, it also gives work(payload_bytes,
out_bytes), the (bytes, operations) that kernel's roofline counts."""
