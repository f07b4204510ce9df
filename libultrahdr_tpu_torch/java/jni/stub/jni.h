/*
 * Minimal jni.h stand-in for building java/jni/uhdr_jni.cpp of the
 * PyTorch/CUDA port on hosts without a JDK (tests/test_torch_java_binding.py):
 * the syntax gate and a full link against the C ABI shim.  As in the real
 * jni.h, every JNIEnv call goes through the env's function table, so a
 * library built against it has no undefined JNI symbol.  The table holds
 * exactly the subset of the JNI C++ API the binding uses, in an order of
 * its own: a library built against this header is a link check and must
 * never be loaded by a JVM.  java/build.py builds the real library against
 * $JAVA_HOME/include/jni.h.
 */
#ifndef UHDR_TPU_STUB_JNI_H
#define UHDR_TPU_STUB_JNI_H

#include <cstdint>

#define JNIEXPORT __attribute__((visibility("default")))
#define JNICALL
#define JNI_ABORT 2

typedef int32_t jint;
typedef int64_t jlong;
typedef int8_t jbyte;
typedef int16_t jshort;
typedef float jfloat;
typedef double jdouble;
typedef uint8_t jboolean;
typedef uint16_t jchar;
typedef jint jsize;

class _jobject {};
typedef _jobject* jobject;
typedef jobject jclass;
typedef jobject jstring;
typedef jobject jarray;
typedef jarray jbyteArray;
typedef jarray jshortArray;
typedef jarray jintArray;
typedef jarray jlongArray;
typedef jarray jfloatArray;
typedef jobject jthrowable;

struct _jfieldID {};
typedef _jfieldID* jfieldID;

struct JNIEnv_;

struct JNINativeInterface_ {
  jclass (*FindClass)(JNIEnv_*, const char*);
  jint (*ThrowNew)(JNIEnv_*, jclass, const char*);
  jboolean (*ExceptionCheck)(JNIEnv_*);
  jclass (*GetObjectClass)(JNIEnv_*, jobject);
  jfieldID (*GetFieldID)(JNIEnv_*, jclass, const char*, const char*);
  jlong (*GetLongField)(JNIEnv_*, jobject, jfieldID);
  void (*SetLongField)(JNIEnv_*, jobject, jfieldID, jlong);
  void (*SetIntField)(JNIEnv_*, jobject, jfieldID, jint);
  jsize (*GetArrayLength)(JNIEnv_*, jarray);
  jbyte* (*GetByteArrayElements)(JNIEnv_*, jbyteArray, jboolean*);
  void (*ReleaseByteArrayElements)(JNIEnv_*, jbyteArray, jbyte*, jint);
  jshort* (*GetShortArrayElements)(JNIEnv_*, jshortArray, jboolean*);
  void (*ReleaseShortArrayElements)(JNIEnv_*, jshortArray, jshort*, jint);
  jint* (*GetIntArrayElements)(JNIEnv_*, jintArray, jboolean*);
  void (*ReleaseIntArrayElements)(JNIEnv_*, jintArray, jint*, jint);
  jlong* (*GetLongArrayElements)(JNIEnv_*, jlongArray, jboolean*);
  void (*ReleaseLongArrayElements)(JNIEnv_*, jlongArray, jlong*, jint);
  void (*GetFloatArrayRegion)(JNIEnv_*, jfloatArray, jsize, jsize, jfloat*);
  void (*SetFloatArrayRegion)(JNIEnv_*, jfloatArray, jsize, jsize, const jfloat*);
  jbyteArray (*NewByteArray)(JNIEnv_*, jsize);
  void (*SetByteArrayRegion)(JNIEnv_*, jbyteArray, jsize, jsize, const jbyte*);
  jfloatArray (*NewFloatArray)(JNIEnv_*, jsize);
  jstring (*NewStringUTF)(JNIEnv_*, const char*);
};

struct JNIEnv_ {
  const JNINativeInterface_* functions;

  jclass FindClass(const char* a0) { return functions->FindClass(this, a0); }
  jint ThrowNew(jclass a0, const char* a1) { return functions->ThrowNew(this, a0, a1); }
  jboolean ExceptionCheck() { return functions->ExceptionCheck(this); }
  jclass GetObjectClass(jobject a0) { return functions->GetObjectClass(this, a0); }
  jfieldID GetFieldID(jclass a0, const char* a1, const char* a2) { return functions->GetFieldID(this, a0, a1, a2); }
  jlong GetLongField(jobject a0, jfieldID a1) { return functions->GetLongField(this, a0, a1); }
  void SetLongField(jobject a0, jfieldID a1, jlong a2) { functions->SetLongField(this, a0, a1, a2); }
  void SetIntField(jobject a0, jfieldID a1, jint a2) { functions->SetIntField(this, a0, a1, a2); }
  jsize GetArrayLength(jarray a0) { return functions->GetArrayLength(this, a0); }
  jbyte* GetByteArrayElements(jbyteArray a0, jboolean* a1) { return functions->GetByteArrayElements(this, a0, a1); }
  void ReleaseByteArrayElements(jbyteArray a0, jbyte* a1, jint a2) { functions->ReleaseByteArrayElements(this, a0, a1, a2); }
  jshort* GetShortArrayElements(jshortArray a0, jboolean* a1) { return functions->GetShortArrayElements(this, a0, a1); }
  void ReleaseShortArrayElements(jshortArray a0, jshort* a1, jint a2) { functions->ReleaseShortArrayElements(this, a0, a1, a2); }
  jint* GetIntArrayElements(jintArray a0, jboolean* a1) { return functions->GetIntArrayElements(this, a0, a1); }
  void ReleaseIntArrayElements(jintArray a0, jint* a1, jint a2) { functions->ReleaseIntArrayElements(this, a0, a1, a2); }
  jlong* GetLongArrayElements(jlongArray a0, jboolean* a1) { return functions->GetLongArrayElements(this, a0, a1); }
  void ReleaseLongArrayElements(jlongArray a0, jlong* a1, jint a2) { functions->ReleaseLongArrayElements(this, a0, a1, a2); }
  void GetFloatArrayRegion(jfloatArray a0, jsize a1, jsize a2, jfloat* a3) { functions->GetFloatArrayRegion(this, a0, a1, a2, a3); }
  void SetFloatArrayRegion(jfloatArray a0, jsize a1, jsize a2, const jfloat* a3) { functions->SetFloatArrayRegion(this, a0, a1, a2, a3); }
  jbyteArray NewByteArray(jsize a0) { return functions->NewByteArray(this, a0); }
  void SetByteArrayRegion(jbyteArray a0, jsize a1, jsize a2, const jbyte* a3) { functions->SetByteArrayRegion(this, a0, a1, a2, a3); }
  jfloatArray NewFloatArray(jsize a0) { return functions->NewFloatArray(this, a0); }
  jstring NewStringUTF(const char* a0) { return functions->NewStringUTF(this, a0); }
};
typedef JNIEnv_ JNIEnv;

#endif /* UHDR_TPU_STUB_JNI_H */
