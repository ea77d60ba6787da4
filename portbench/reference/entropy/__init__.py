"""The reference's entropy decoders, one file each: a file names the
entropy ids it decodes (IDS) and gives decode(bits, length)."""
